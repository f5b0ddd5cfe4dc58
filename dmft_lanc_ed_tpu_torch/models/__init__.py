"""Model drivers of the PyTorch port: hm_bethe, bhz_2d, the single-impurity
drivers dos_driver, hm_vhs, vo2, hm_bethe_afm, hm_2b_square,
multiorb_kanamori, from_hk and square_family, and the real-space drivers
on the lattice bank (``lattice.py``): layered (``run_layered``),
hm_square_afm2, bhz_2d_edge, wsm_slab, bhz_slab, hm_2b_afo and pco."""
