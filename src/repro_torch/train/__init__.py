"""Training of the LM stack: optimizers, int8 gradient compression, the
synthetic data pipeline and the train step (the reference's ``train/``)."""
