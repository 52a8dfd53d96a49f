"""Panel store and windowing of the port."""

from lfm_quant_tpu_torch.data.panel import Panel, PanelSplits, synthetic_panel

__all__ = ["Panel", "PanelSplits", "synthetic_panel"]
