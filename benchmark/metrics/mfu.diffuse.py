"""Model FLOPs of a call (one reference denoiser pass and one audio-encoder
call under FlopCounterMode, times the call's passes and windows) at the
window's rate of calls, over the bf16 peak (percent)."""
from rooflines import mfu as read  # noqa: F401
