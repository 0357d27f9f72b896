"""Disaggregated prefill/decode serving plane (see ``plane.py``)."""
from repro_torch.serving.disagg.plane import DisaggPlane, DisaggStats

__all__ = ['DisaggPlane', 'DisaggStats']
