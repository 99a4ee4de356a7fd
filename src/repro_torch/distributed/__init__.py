"""The port's distribution layer: the logical-axis sharding policy
(``sharding``) the engine's sharded execution reads."""
