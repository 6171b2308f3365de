"""plan_roofline.minhash: the signing path's share of its bound in the dedup
cells (``bench/roofline.py``'s ``device_share``, over the traced window)."""
from bench.roofline import device_share as read  # noqa: F401
