"""Runtime of the PyTorch port: the shape-bucket grid (:mod:`.shapes`),
coalesced host <-> device staging (:mod:`.staging`) and the failure
taxonomy the serving runtime uses (:mod:`.resilience`)."""
