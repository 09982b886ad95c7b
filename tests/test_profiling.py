"""Device-time reduction of a profiler trace (utils/profiling.py)."""

import pytest

from gfx_ocean_tpu.utils.profiling import device_busy_us


def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": name}}


def _x(pid, ts, dur, name="k"):
    return {"ph": "X", "pid": pid, "tid": 1, "ts": ts, "dur": dur,
            "name": name}


def test_device_busy_is_union_of_gpu_events():
    events = [
        _meta(1, "/host:CPU"), _meta(7, "/device:GPU:0"),
        _meta(8, "/device:GPU:1"),
        _x(1, 0.0, 500.0),                  # host: ignored
        _x(7, 10.0, 5.0), _x(7, 12.0, 6.0),  # overlap -> [10, 18]
        _x(7, 30.0, 2.0),                    # [30, 32]
        _x(8, 31.0, 4.0),                    # other stream/device -> [30, 35]
        {"ph": "i", "pid": 7, "ts": 40.0, "name": "instant"},
    ]
    assert device_busy_us(events) == pytest.approx(8.0 + 5.0)


def test_device_busy_raises_without_gpu_events():
    events = [_meta(1, "/host:CPU"), _x(1, 0.0, 100.0),
              _meta(7, "/device:GPU:0")]
    with pytest.raises(RuntimeError, match="no GPU device events"):
        device_busy_us(events)
