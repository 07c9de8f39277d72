"""Data makers, one file per generator: ``make(cfg, seed, index, device)``
returns dataset `index` of seed `seed` as a (trials * samples, channels)
float32 numpy payload; ``trialdefinition(cfg)`` its trials."""
