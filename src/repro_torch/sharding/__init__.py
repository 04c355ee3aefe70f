"""The sharding rules (``specs``) and the activation-sharding context
(``ctx``) of the sharded steps."""
