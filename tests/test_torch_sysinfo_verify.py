"""The port's system auto-detection and unit-log verification
(`repro_torch.core.sysinfo`, `repro_torch.core.verify`) held against the
reference's: the six cases of tests/test_sysinfo_verify.py on the port,
each log verified by both packages with equal reports (clean, carbon
tampered, a unit lost), a TPU kind giving the reference's profile and a
CPU host the v5e default, and the NVIDIA H100 row."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.core import sysinfo as RS  # noqa: E402
from repro.core.verify import verify_unit_log as ref_verify  # noqa: E402

from repro_torch.core import sysinfo as S  # noqa: E402
from repro_torch.core.carbon import GridCarbonModel  # noqa: E402
from repro_torch.core.tracker import RunTracker  # noqa: E402
from repro_torch.core.verify import verify_unit_log  # noqa: E402


def _both(path):
    """The port's report and the reference's on one log, required equal."""
    got, ref = verify_unit_log(str(path)), ref_verify(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    return got


def _log(tmp_path, n, **unit):
    log = tmp_path / "units.jsonl"
    t = RunTracker("v", log_path=str(log))
    for i in range(n):
        t.record_unit(sim_time_h=float(i), **unit)
    t.close()
    return log


def test_detect_host_fields():
    info = S.detect_host()
    assert info["cpus"] >= 1
    assert {"torch_backend", "torch_devices", "torch_device_kind"} <= set(info)
    if not torch.cuda.is_available():
        assert info["torch_backend"] == "cpu"
        assert info["torch_device_kind"] == "cpu"
    for key in ("hostname", "machine", "system", "cpus", "mem_gb"):
        assert info[key] == RS.detect_host()[key]


def test_machine_profile_autodetect():
    m = S.machine_profile_from_host()
    assert m.idle_w > 0 and m.dyn_w > m.idle_w * 0.5
    assert m.name.startswith("auto-")
    info = {"cpus": 12, "hostname": "h"}
    assert dataclasses.asdict(S.machine_profile_from_host(info)) == \
        dataclasses.asdict(RS.machine_profile_from_host(info))


@pytest.mark.parametrize("kind", ["cpu", "TPU v4", "TPU v5e", "TPU v5 lite",
                                  "TPU v5p", "unknown"])
def test_chip_profile_autodetect_defaults_v5e(kind):
    got = S.chip_profile_from_host({"torch_device_kind": kind})
    ref = RS.chip_profile_from_host({"jax_device_kind": kind})
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if kind in ("cpu", "unknown"):
        assert got.name == "tpu-v5e"
    if kind == "TPU v4":
        assert got.name == "tpu-v4"


def test_chip_profile_h100_row():
    c = S.chip_profile_from_host({"torch_device_kind":
                                  "NVIDIA H100 80GB HBM3"})
    assert c is S.H100 and c.name == "nvidia-h100"
    assert (c.peak_flops, c.hbm_bw, c.ici_bw, c.tdp_w) == (989e12, 3.35e12,
                                                           450e9, 700.0)
    assert c.pj_per_flop == pytest.approx(700.0 / 989e12 * 1e12, rel=1e-12)
    assert 0 < c.idle_w < c.tdp_w
    assert S.chip_profile_from_host({}).name == "tpu-v5e"


def test_verify_clean_log(tmp_path):
    log = _log(tmp_path, 5, phase="night", intensity=0.9, runtime_s=10.0,
               energy_kwh=0.02)
    rep = _both(log)
    assert rep.ok, rep.errors
    assert rep.n_units == 5
    assert abs(rep.energy_kwh - 0.1) < 1e-9


def test_verify_detects_tampering(tmp_path):
    log = _log(tmp_path, 3, phase="peak", intensity=0.4, runtime_s=5.0,
               energy_kwh=0.01)
    lines = log.read_text().splitlines()
    rec = json.loads(lines[1])
    rec["co2_kg"] *= 2            # corrupt the carbon translation
    lines[1] = json.dumps(rec)
    log.write_text("\n".join(lines) + "\n")
    rep = _both(log)
    assert not rep.ok
    assert any("carbon mismatch" in e for e in rep.errors)


def test_verify_detects_missing_units_vs_summary(tmp_path):
    log = _log(tmp_path, 4, phase="shoulder", intensity=0.9, runtime_s=5.0,
               energy_kwh=0.01)
    lines = log.read_text().splitlines()
    del lines[0]                  # lose a unit (simulated crash/partial copy)
    log.write_text("\n".join(lines) + "\n")
    rep = _both(log)
    assert not rep.ok
    assert any("summary" in e for e in rep.errors)


def test_verify_takes_the_carbon_model(tmp_path):
    """A log written under an hourly curve verifies against that curve,
    and not against the flat default, in both packages."""
    curve = [0.5 + 0.04 * h for h in range(24)]
    log = tmp_path / "units.jsonl"
    t = RunTracker("v", carbon=GridCarbonModel(hourly_curve=curve),
                   log_path=str(log))
    for i in range(6):
        t.record_unit(phase="p", intensity=1.0, runtime_s=1.0,
                      energy_kwh=0.5, sim_time_h=3.0 * i)
    t.close()
    from repro.core.carbon import GridCarbonModel as RefCarbon
    got = verify_unit_log(str(log), GridCarbonModel(hourly_curve=curve))
    ref = ref_verify(str(log), RefCarbon(hourly_curve=curve))
    assert got.ok and dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert not verify_unit_log(str(log)).ok
