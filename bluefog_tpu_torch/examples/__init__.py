"""User-facing example programs of the port, run as modules
(``python -m bluefog_tpu_torch.examples.<name>``)."""
