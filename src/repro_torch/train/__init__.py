"""Training substrate of the port: losses, optimizers, the train step,
data, fault tolerance and checkpoints (``repro.train``'s counterpart)."""
