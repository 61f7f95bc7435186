"""Model FLOPs a unit (the reference's count under FlopCounterMode at the
cell's shapes) at the window's rate, over the bf16 peak (percent)."""
from rooflines import mfu as read  # noqa: F401
