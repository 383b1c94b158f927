"""The port's observability utilities (port of tests/test_observability.py):
``ThroughputMeter``, ``StageTimer``, ``trace`` and ``device_memory_stats``
of ``rrtmg_lw_torch.utils.profiling`` and ``device_seconds_per_iter`` of
``utils.device_time``, with the JAX package's contracts, on the CPU (no
device events here: the device time is None, the memory stats None); the
glue's split by op (``_device_work``, ``glue_ops``) on stand-in profiler
events; and the error flag ``cld_bounds_ok``, flipped by an out-of-range
ice size while the fluxes stay finite.
"""

import json
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rrtmg_lw_torch import Atmosphere, LWConfig, McicaClouds, make_model
from rrtmg_lw_torch.utils import profiling
from rrtmg_lw_torch.utils.device_time import device_seconds_per_iter
from rrtmg_lw_torch.utils.profiling import (StageTimer, ThroughputMeter,
                                            device_memory_stats, trace)
from rrtmg_lw_torch.utils.synthetic import make_atmosphere, make_mcica_clouds

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_throughput_meter():
    meter = ThroughputMeter()
    for _ in range(3):
        with meter.step(ncols=128) as h:
            h["result"] = (torch.ones(128) * 2, [torch.zeros(3)])
    rep = meter.report()
    assert rep["columns"] == 384 and rep["steps"] == 3
    assert rep["columns_per_sec"] > 0 and meter.columns_per_sec > 0
    with meter.step(ncols=10, result=torch.ones(4)):
        pass
    assert meter.steps == 4 and meter.columns == 394


def test_stage_timer():
    t = StageTimer()
    out = t.measure("add", lambda x: x + 1, torch.ones(64), iters=3)
    assert torch.equal(out, torch.full((64,), 2.0))
    assert "add" in t.report()
    assert t.report()["add"] >= 0
    assert str(t).startswith("add ")


def test_memory_stats_none_on_cpu():
    assert device_memory_stats(CPU) is None
    assert device_memory_stats("cpu") is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path), device="cpu") as logdir:
        torch.ones(256, 256) @ torch.ones(256, 256)
    assert logdir == str(tmp_path)
    files = list(pathlib.Path(tmp_path).glob("trace_*.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]


def test_device_time_none_without_device_events():
    model = make_model(LWConfig(icld=0, use_lut=False), device="cpu")
    atm = Atmosphere.from_numpy(make_atmosphere(4, 12), "cpu")
    model(atm)
    sec, detail = device_seconds_per_iter(lambda: model(atm), iters=2)
    assert sec is None
    assert set(detail) == {"error"} and "no CUDA events" in detail["error"]


def _event(name, start, end):
    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CUDA,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_glue_split_by_op():
    """Two traced steps: K1 clear and K2 by their symbols, the rest of
    the CUDA events grouped by name, each ms per step; host events left
    out; busy the union of the device intervals."""
    mul = "void at::native::vectorized_elementwise_kernel<4, Mul>(int, Mul)"
    events = [
        _event("void rt_kernel<0, false, 0, 0>(Args)", 0, 1000),
        _event("void taumol_kernel<0>(Args)", 1000, 1600),
        _event(mul, 1600, 1700), _event(mul, 5000, 5100),
        _event("Memcpy HtoD (Pageable -> Device)", 1650, 1800),
        _event("void " + "x" * 300, 2000, 2010),
        SimpleNamespace(name="aten::mul", device_type=torch.autograd.
                        DeviceType.CPU, time_range=None)]
    prof = SimpleNamespace(events=lambda: events)
    busy, kernels, dev, glue = profiling._device_work(prof, 2)
    assert len(dev) == 6
    assert busy == pytest.approx((1800 + 10 + 100) / 1e3 / 2)
    assert kernels == pytest.approx({"K1 clear": 0.5, "K2": 0.3})
    assert glue == pytest.approx({
        mul: 0.1, "Memcpy HtoD (Pageable -> Device)": 0.075,
        "void " + "x" * 300: 0.005})
    ops = profiling.glue_ops(glue)
    assert list(ops) == [mul.removeprefix("void "),
                         "Memcpy HtoD (Pageable -> Device)",
                         "x" * profiling.GLUE_NAME]
    many = {f"op{i:02d}": float(i) for i in range(profiling.GLUE_OPS + 5)}
    assert list(profiling.glue_ops(many)) == [
        f"op{i:02d}" for i in range(profiling.GLUE_OPS + 4, 4, -1)]


def test_cld_bounds_flag_surfaces():
    m = make_model(LWConfig(icld=2, imca=1, dtype="float64"), device="cpu")
    atm = Atmosphere.from_numpy(make_atmosphere(2, 16), "cpu")
    cl = McicaClouds.from_numpy(make_mcica_clouds(2, 16, layout="batch"),
                                "cpu")
    fl = m(atm, cl)
    assert fl.cld_bounds_ok is not None
    assert fl.cld_bounds_ok.shape == (2, 16)
    assert bool(fl.cld_bounds_ok.all())
    # an out-of-range ice size flips the flag without aborting
    reic = cl.reicmc.clone()
    reic[0, 3] = 500.0
    fl2 = m(atm, cl._replace(reicmc=reic))
    assert not bool(fl2.cld_bounds_ok[0, 3])
    assert int((~fl2.cld_bounds_ok).sum()) == 1
    assert np.isfinite(fl2.uflx.numpy()).all()
