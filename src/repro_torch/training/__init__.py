"""Training of the port: optimizers and the train step."""
