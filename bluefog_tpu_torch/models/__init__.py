"""Models of the port (the transformer LM; the vision zoo is a later slice)."""

from .transformer import TransformerLM, apply_rope, lm_loss

__all__ = ["TransformerLM", "apply_rope", "lm_loss"]
