"""Model configurations of the LM stack (dataclasses, no tensors)."""
