"""chip_smoke.py's phases at tiny sizes on the CPU (the scan chain DP and
the kernel in the Pallas interpreter), and its refusal to run without a
GPU. The script itself runs on the card: python chip_smoke.py."""

import importlib.util
import json
import os
import sys

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses resolve their module
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref(smoke):
    return smoke.phase_reference(300_000, seed=5)


def test_main_refuses_without_gpu(smoke, capsys):
    assert smoke.main([]) != 0
    assert smoke.main(["--four"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and not out.strip().startswith("{")


def test_phase_headline_and_chain(smoke, ref, capsys):
    reads, lines = smoke.phase_headline(ref, 24, stride=3)
    assert len(reads) == 24 and lines
    times = smoke.phase_chain(ref, [("headline", reads, 1024, 8)], interpret=True)
    assert set(times["headline"]) == {"kernel", "scan"}
    out = capsys.readouterr().out
    assert "phase b_headline: parity=ok" in out
    assert "phase f_chain_headline: parity=ok" in out


def test_phase_longread(smoke, ref, capsys):
    smoke.phase_longread(ref, 6, n_check=8, n_tier=4)
    out = capsys.readouterr().out
    assert "phase c_longread: parity=ok" in out
    assert "phase c_tier2: parity=ok" in out


def test_phase_paths(smoke, capsys):
    smoke.phase_paths(200_000, 6)
    out = capsys.readouterr().out
    for name in ("hifi_k19", "hpc", "even_k14", "general", "skip_prune"):
        assert f"phase d_{name}: parity=ok" in out
    assert "MM2T_SKIP_PRUNE" not in os.environ


def test_phase_cli(smoke, capsys):
    smoke.phase_cli(200_000, 8)
    out = capsys.readouterr().out
    assert "phase e_cli_align: parity=ok" in out
    assert "phase e_index_build: parity=ok" in out


def test_phase_four_on_virtual_devices(smoke, ref, capsys):
    reads = smoke._sim(ref.genome, 16, (500, 1000), 9)
    smoke.phase_four(ref, reads, stride=2)
    out = capsys.readouterr().out
    for name in ("single", "dp4", "dp2_ix2"):
        assert f"phase four_{name}: parity=ok" in out


def test_report_fails_on_mismatch(smoke):
    with pytest.raises(AssertionError):
        smoke.report("x", False, n=1)


def test_last_line_is_device_json(smoke, monkeypatch, capsys):
    """With a (faked) GPU and the phases stubbed out, main() ends in the
    one-line JSON the contract names."""
    import jax

    class Dev:
        platform, device_kind = "gpu", "Fake GPU"

        def memory_stats(self):
            return {"peak_bytes_in_use": 1}

    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    monkeypatch.setattr(smoke, "gpu_name_and_power", lambda: "Fake GPU, 700.00 W")
    for ph in ("phase_reference", "phase_headline", "phase_longread",
               "phase_paths", "phase_cli", "phase_chain"):
        monkeypatch.setattr(smoke, ph, lambda *a, **k: (None, None))
    assert smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().split("\n")
    assert "Fake GPU, 700.00 W" in lines[:-1]
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "Fake GPU", "count": 1},
    }
