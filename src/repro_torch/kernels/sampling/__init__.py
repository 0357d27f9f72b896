"""Fused unembed + sampling."""
