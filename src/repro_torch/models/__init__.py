"""The LM stack of the port (serving of the attention families): layers,
frontend stubs, the decoder stack and the model facade."""
