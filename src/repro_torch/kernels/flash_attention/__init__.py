"""Flash attention (whole-prompt prefill)."""
