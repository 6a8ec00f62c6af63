"""The span reductions (``portbench/spans.py``) on spans made up here."""

import numpy as np
import pytest

from portbench import spans as sp


def _span(i, name, parent, a, b, device_s=None):
    return dict(name=name, id=i, parent=parent, root=None, start_ns=a,
                end_ns=b, device_s=device_s)


SPANS = [_span(1, "backward", None, 0, 100, 0.5),
         _span(2, "dp", 1, 10, 50, 0.2), _span(3, "dp", 1, 60, 70, 0.1),
         _span(4, "heads", None, 100, 120, 0.05)]


def test_device_and_self_seconds():
    assert sp.device_seconds(SPANS, "dp") == pytest.approx(0.3)
    assert sp.self_seconds(SPANS, "backward") == pytest.approx(0.2)
    assert sp.device_seconds(SPANS, "loss") is None
    assert sp.self_seconds(SPANS, "loss") is None


def test_idle_by_span_and_innermost():
    busy = np.array([[0, 20], [40, 65], [90, 110]])
    # idle 20-40, 65-90 and 110-130: under dp 20-40 and 65-70, under
    # backward alone 70-90, under heads 110-120, under no span 120-130
    assert sp.idle_by_span(SPANS, busy, 0, 130) == \
        {"dp": 25, "backward": 20, "heads": 10, None: 10}
    assert sp.idle_by_span([], busy, 0, 130) == {None: 65}
    gaps = [(20, 40), (65, 90), (114, 130)]
    assert sp.innermost(SPANS, gaps) == ["dp", "backward", None]
