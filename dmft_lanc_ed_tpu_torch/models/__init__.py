"""Model drivers of the PyTorch port (hm_bethe and bhz_2d so far, ROADMAP A8)."""
