"""Share of the traced stretch of the SLAM drive in which nothing ran on
the card: one less the union of the device records' intervals over the
stretch's length."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
