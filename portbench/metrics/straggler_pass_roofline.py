"""The RaBitQ straggler pass's share of its roofline: ``second_pass_roofline``'s
yardstick and reader over the ``rerank.stragglers`` stage.  The least time
of the stragglers' exact work at the published H100 peaks
(``pass_work.second_pass_work`` on each call's ``n_second_pass``, which the
batched RaBitQ searcher sets to each query's stragglers), a mean over the
traced calls, over the device time launched inside the stage a counted
call, so a dense exact pass over every lane reads as the waste it is.
None without a device trace or without the stage."""
from pathlib import Path

from portbench import harness

_reader = harness.load_module(
    Path(__file__).with_name("second_pass_roofline.py"), "metric")
_reader.STAGE = "rerank.stragglers"     # this module's own copy of it
read = _reader.read
