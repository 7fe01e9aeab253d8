"""Launch-side helpers: the LM path's step functions and serving loop,
and the client process group of the shard_map backend (``mesh``)."""
