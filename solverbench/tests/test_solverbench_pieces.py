"""Discovery of configurations, cells and metrics from their files, and
the arithmetic of the yardstick: bytes of a product, the idle share of a
timeline, step_s over whole steps."""

import json
import types

import pytest

from solverbench import check, roofline, trace, traffic
from solverbench.harness import Run, Step
from solverbench.spec import Bench


def test_cells_and_metrics_found_by_name(fixture_root):
    bench = Bench(str(fixture_root))
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert "pc_type" in cell.traffic
        names = [m["name"] for m in bench.metrics(w["name"], False)]
        assert names == ["step_s", "setup_s"]
        for m in bench.metrics(w["name"], True):
            assert callable(bench.reader(m["name"]))
    with pytest.raises(KeyError):
        bench.cell("no-such-cell")


def test_a_new_cell_and_metric_are_only_files_and_entries(fixture_root):
    """A fixture configuration, traffic mix and per-layer metric, added as
    files and BENCHMARK.json entries, are found without a code change."""
    data = fixture_root / "solverbench"
    cfg = json.loads((data / "configs" / "swelling2d-n160.json").read_text())
    cfg.update(name="swelling2d-fixture", N=3)
    (data / "configs" / "swelling2d-fixture.json").write_text(json.dumps(cfg))
    trf = json.loads((data / "traffic" / "inexact-diagonal-3way.json").read_text())
    trf.update(pc_type="diagonal", t0=[0.0, 0.3], t0_step=0.1)
    (data / "traffic" / "inexact-diagonal.json").write_text(json.dumps(trf))
    (data / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return float(len(run.steps))\n")
    spec = json.loads((fixture_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "fixture", "config": "swelling2d-fixture",
                              "traffic": "inexact-diagonal", "chips": 1, "why": "fixture"})
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "time loop",
                              "moves": "step_s", "workloads": ["fixture"]})
    (fixture_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(str(fixture_root))
    cell = bench.cell("fixture")
    assert cell.config["N"] == 3 and cell.traffic["pc_type"] == "diagonal"
    traced = [m["name"] for m in bench.metrics("fixture", True)]
    assert "steps_in_window" in traced
    assert "steps_in_window" not in [m["name"] for m in bench.metrics(
        spec["workloads"][0]["name"], True)]
    run = Run(1.0, 0.1, 0.2, 3.0, [object()] * 3, [])
    assert bench.reader("steps_in_window")(run) == 3.0


def test_an_aar_cell_from_files_alone_runs_correct(fixture_root, monkeypatch):
    """A cell whose traffic asks for the AAR outer solver (with an options
    file of its own, without the inexact file's ``-global_ksp_type gmres``,
    which overrides the flag) and a parameter of the driver, on a
    configuration with a mesh refinement and a time step of its own, added
    as files and an entry: the flags and parameters reach the driver, the
    outer solver is AAR, the reference follows the configuration, and the
    run is correct."""
    import io
    import time

    from porotpu_torch.drivers import swelling
    from porotpu_torch.models import poromechanics

    from solverbench import harness

    data = fixture_root / "solverbench"
    cfg = json.loads((data / "configs" / "swelling2d-n160.json").read_text())
    cfg.update(name="swelling2d-fixture", N=3, refinements=1, parameters={"dt": 0.05})
    (data / "configs" / "swelling2d-fixture.json").write_text(json.dumps(cfg))
    trf = json.loads((data / "traffic" / "inexact-diagonal-3way.json").read_text())
    options = (data / "traffic" / trf["options_file"]).read_text()
    (data / "traffic" / "options-aar.txt").write_text(
        options.replace("-global_ksp_type gmres", ""))
    # AAR reports the 2-norm of its residual, not the field-wise one that
    # resid_gap compares: the traffic holds it to the configuration's test
    trf.update(options_file="options-aar.txt", args=["--solver-type", "aar"],
               parameters={"solver maxiter": 400}, steps=3, limits={"resid_q": 1.0})
    (data / "traffic" / "inexact-aar.json").write_text(json.dumps(trf))
    spec = json.loads((fixture_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "swelling-aar-fixture", "config": "swelling2d-fixture",
                              "traffic": "inexact-aar", "chips": 1, "why": "fixture"})
    (fixture_root / "BENCHMARK.json").write_text(json.dumps(spec))
    seen = {}
    setup = swelling.setup

    def spy(argv, overrides):
        seen.update(argv=argv, overrides=overrides)
        problem = setup(argv, overrides)
        seen["problem"] = problem
        return problem

    monkeypatch.setattr(swelling, "setup", spy)
    aar_calls = []
    aar = poromechanics.aar

    def aar_spy(*args, **kwargs):
        aar_calls.append(1)
        return aar(*args, **kwargs)

    monkeypatch.setattr(poromechanics, "aar", aar_spy)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell("swelling-aar-fixture", 2**31 + 21, 60.0, False, time.perf_counter(),
                          bench=Bench(str(fixture_root)), device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] == 4, err.getvalue()[-2000:]
    assert list(res["checks"]) == ["resid_q"]
    argv = seen["argv"]
    assert argv[-2:] == ["--solver-type", "aar"]
    assert argv[argv.index("--N-refinements") + 1] == "1"
    assert seen["overrides"]["dt"] == 0.05 and seen["overrides"]["solver maxiter"] == 400
    assert seen["problem"].dt == 0.05
    assert len(aar_calls) == 4  # every step's outer solve


def test_seeded_inputs_repeat_and_stay_in_range():
    trf = {"t0": [0.0, 0.5], "t0_step": 0.1, "load_factor": [0.5, 2.0]}
    a = traffic.draw(trf, 2**31 + 12345, ["fs_sur", "ff_sur"])
    assert a == traffic.draw(trf, 2**31 + 12345, ["fs_sur", "ff_sur"])
    assert len(set(a[1].values())) == 1
    assert a != traffic.draw(trf, 7, ["fs_sur", "ff_sur"])
    for seed in range(50):
        t0, f = traffic.draw(trf, seed, ["fs_sur"])
        assert 0.0 <= t0 <= 0.5 + 1e-12 and abs(t0 * 10 - round(t0 * 10)) < 1e-9
        assert 0.5 <= f["fs_sur"] <= 2.0


def test_judged_steps_are_the_first_the_last_and_a_seeded_sample():
    assert check.sample(5, 1) == [0, 1, 2, 3, 4]
    picked = check.sample(200, 2**31 + 3)
    assert len(picked) == check.CHECKED == len(set(picked))
    assert picked[0] == 0 and picked[-1] == 199 and picked == sorted(picked)
    assert picked == check.sample(200, 2**31 + 3) != check.sample(200, 4)


def test_bytes_of_a_product_from_its_shapes():
    # K1: 9 diagonals of 100 rows, an embedded input of 120, output 100, f64
    assert roofline.dia_bytes(9, 100, 120, 100, 8) == (900 + 120 + 100) * 8
    # K2 on the same layout: input 100 (the rows), output 120
    assert roofline.dia_bytes(9, 100, 100, 120, 8) == (900 + 100 + 120) * 8
    # ELL: 50 rows of width 7, f64 values, int64 indices, input 80
    assert roofline.ell_bytes(50, 7, 80, 8) == 350 * 16 + (80 + 50) * 8
    assert roofline.share(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.share(1.0, 0.0) is None


def _ev(name, dev, start, end, corr=0):
    return trace.Event(name, dev, start, end, corr)


def test_idle_share_and_kernel_times_on_a_synthetic_timeline():
    # window 0..1000 ns; kernels 100-300 and 250-400 overlap (busy 100-400),
    # 600-700; a copy 800-850; an ELL span launching the 600-700 kernel,
    # running while the device idles from 400 to 600
    ev = [
        _ev(trace.WINDOW, False, 0, 1000),
        trace.Event(trace.WINDOW, True, 0, 1000, 0, annotation=True),
        _ev("outer", False, 0, 1000),
        _ev("void dia_mv_kernel<double>", True, 100, 300, corr=1),
        _ev("void dia_rmv_kernel<double>", True, 250, 400, corr=2),
        _ev(trace.ELL_SPAN, False, 450, 560),
        _ev("cudaLaunchKernel", False, 520, 530, corr=3),
        _ev("gather", True, 600, 700, corr=3),
        _ev("Memcpy DtoH", True, 800, 850, corr=4),
        _ev("outside", True, 1200, 1300, corr=5),
    ]
    tr = trace.reduce_trace(ev)
    assert tr.window_s == pytest.approx(1000e-9)
    assert tr.busy_s == pytest.approx(450e-9)  # 300 + 100 + 50
    assert tr.kernels == 3 and tr.k1_launches == 1 and tr.k2_launches == 1
    assert tr.k1_s == pytest.approx(200e-9) and tr.k2_s == pytest.approx(150e-9)
    assert tr.ell_s == pytest.approx(100e-9) and tr.ell_spans == 1
    idle = dict(tr.idle_gaps)
    assert sum(idle.values()) == pytest.approx(550e-9)
    assert idle[trace.ELL_SPAN] == pytest.approx(200e-9)  # the gap 400-600
    assert trace.reduce_trace(ev[1:]) is None


def test_idle_share_sets_the_traced_busy_time_against_the_windows_pace():
    # 2 traced steps busy 0.3 s in all, stretched by the profiler to 1.6 s;
    # the window ran 4 steps in 2.0 s: the traced steps take 1.0 s untraced
    tr = trace.Trace(window_s=1.6, busy_s=0.3, kernels=10)
    run = Run(0, 0, 0, 2.0, [object()] * 4, [], trace=tr, traced_steps=2)
    assert run.device_window_s() == pytest.approx(1.0)
    bench = Bench()
    assert bench.reader("device_idle_share")(run) == pytest.approx(70.0)
    assert bench.reader("launches_per_step")(run) == 5
    assert bench.reader("device_idle_share")(Run(0, 0, 0, 2.0, [object()] * 4, [])) is None
    assert bench.reader("device_idle_share")(Run(0, 0, 0, 0, [], [], trace=tr)) is None


def test_step_s_counts_whole_steps_and_roofline_reads_the_launches_traced():
    bench = Bench()
    steps = [Step(0.1 * k, 5, 0.7, True, 1e-9, None) for k in range(4)]
    run = Run(30.0, 10.0, 12.0, 2.8, steps, [0.01, 0.03])
    assert bench.reader("step_s")(run) == pytest.approx(0.7)
    assert bench.reader("iters_per_step")(run) == 5
    assert bench.reader("rhs_ms")(run) == pytest.approx(20.0)
    assert bench.reader("step_s")(Run(1, 0, 0, 1.0, [], [])) is None
    tr = trace.Trace(window_s=1.0, busy_s=0.5, kernels=10, k1_s=1e-3, k1_launches=2)
    pr = trace.Products(k1_calls=2, k1_bytes=int(3.35e9 * 0.5))
    run = Run(0, 0, 0, 0, [], [], trace=tr, products=pr, traced_steps=2)
    assert bench.reader("k1_roofline")(run) == pytest.approx(50.0)
    pr.k1_calls, pr.k1_bytes = 4, 2 * pr.k1_bytes  # two records lost: the mean times the two
    assert bench.reader("k1_roofline")(run) == pytest.approx(50.0)
    assert bench.reader("k2_roofline")(run) is None
    assert bench.reader("ell_roofline")(types.SimpleNamespace(trace=None, products=None)) is None
