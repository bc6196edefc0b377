"""The plain references: float32 PyTorch with TF32 off, written from the
published descriptions of each configuration's family, in blocks so that
they fit beside nothing on the card. They import nothing of the port and
take nothing it made: the weights and inputs are drawn again from the
seed (``portbench.weights``, ``portbench.data``). ``precision="fp8"``
computes every product of the same model from float8 operands (the
control: the step below the configuration's bf16)."""
