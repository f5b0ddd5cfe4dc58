"""Model drivers of the PyTorch port (only hm_bethe so far, ROADMAP A8)."""
