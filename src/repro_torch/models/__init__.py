"""The LM stack of the port (serving and training of every family:
attention, MoE, SSM, hybrid): layers, the SSM mixers, the MoE FFN,
frontend stubs, the decoder stack and the model facade."""
