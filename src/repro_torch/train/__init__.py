"""Training substrate of the port: checkpointing and fault tolerance."""
