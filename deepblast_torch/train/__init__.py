"""The model object (``DeepBLAST``) and its checkpoints."""
