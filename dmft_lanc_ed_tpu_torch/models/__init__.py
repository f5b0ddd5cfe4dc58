"""Model drivers of the PyTorch port: hm_bethe, bhz_2d and the
single-impurity drivers dos_driver, hm_vhs, vo2, hm_bethe_afm,
hm_2b_square, multiorb_kanamori, from_hk and square_family; the lattice
drivers are still to port (ROADMAP A8b)."""
