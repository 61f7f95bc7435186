"""Share of the traced window with no device operation running (percent):
one minus the union of kernel, copy and set intervals over the window."""
from rooflines import idle_share as read  # noqa: F401
