"""plan_roofline.scan: the scan's share of its bound in the scan cells
(``bench/roofline.py``'s ``device_share``, over the traced window)."""
from bench.roofline import device_share as read  # noqa: F401
