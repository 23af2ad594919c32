"""Share of the traced window with no device operation running."""
from zsbench.readers import idle_pct as value  # noqa: F401
