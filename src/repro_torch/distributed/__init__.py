"""The port's distribution layer: the logical-axis sharding policy
(``sharding``) that the engine's sharded execution and the LM's sharded
train step read."""
