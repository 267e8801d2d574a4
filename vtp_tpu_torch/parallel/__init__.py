"""Parameter layouts of the port's parallelism: the head-major qkv layout
(``sharding.py``). Process groups and sharded modules are not ported yet."""
