"""The bound-fused RaBitQ scan's (#5, ``rabitq_fused_kernel``) share of its
roofline in the 960-d RaBitQ cell: ``rabitq_fused_roofline``'s yardstick
(the least time of ``roofline.rabitq_scan_work`` at the published H100
peaks over the kernel's device time in the counted calls), read by that
metric's own reader."""
from pathlib import Path

from portbench import harness

read = harness.load_module(
    Path(__file__).with_name("rabitq_fused_roofline.py"), "metric").read
