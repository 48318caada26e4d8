"""Smoke tests for the argparse CLI surfaces not covered by the integration
tests: the workflow driver CLI (config parse, classifier-path convention,
Snakemake-style freshness skip), collect, summarize_mix,
summarize_titration, and analyze_multispecies."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from hiprfish_tpu.config import TEN_BIT


def _mix_fixture(base_dir, rng, mix_id=3):
    """cell_ids/avgint files for two FOVs + the experiment table; returns
    (data_dir, table_path)."""
    data_dir = base_dir / "data"
    folder = data_dir / "mixrun"
    folder.mkdir(parents=True)
    rows = []
    for fov in (1, 2):
        image_name = f"mix_{mix_id}_fov_{fov}"
        codes = rng.choice([5, 37, 515], size=30)
        with open(folder / f"{image_name}_cell_ids.txt", "w") as f:
            for c in codes:
                f.write(TEN_BIT.code_str(int(c)) + "\n")
        np.savetxt(folder / f"{image_name}_avgint.csv", rng.rand(30, 95),
                   delimiter=",")
        rows.append({"SAMPLE": "mixrun", "IMAGES": image_name,
                     "CALIBRATION": "F", "CALIBRATION_FILENAME": "x",
                     "REFERENCE_FOLDER": "r"})
    table = base_dir / f"images_table_mix_{mix_id}.csv"
    pd.DataFrame(rows).to_csv(table, index=False)
    return data_dir, table


def test_cli_collect_and_summarize_mix(tmp_path, rng):
    from hiprfish_tpu.cli import collect as cli_collect
    from hiprfish_tpu.cli import summarize_mix as cli_mix

    data_dir, table = _mix_fixture(tmp_path, rng)
    out = tmp_path / "images_table_mix_3_results.csv"
    cli_collect.main([str(data_dir), str(table), str(out), "-t", "M"])
    ab = tmp_path / "images_table_mix_3_results_abundance.csv"
    assert ab.exists()
    assert pd.read_csv(ab).shape[0] == 1023
    cli_mix.main([str(ab)])
    base = str(ab)[:-len(".csv")]
    assert os.path.exists(base + "_barcodes.pdf")
    assert os.path.exists(base + "_distribution.pdf")


def test_cli_summarize_titration(tmp_path, rng):
    from hiprfish_tpu.cli import summarize_titration as cli_t

    # abundance counts proportional to the input concentrations -> the
    # regression must find a positive slope with r ~ 1
    conc = {5: 1.0, 37: 2.0, 515: 4.0}
    ab = pd.DataFrame({"Barcodes": np.arange(1, 1024)})
    for fov in (1, 2):
        col = np.zeros(1023, int)
        for code, c in conc.items():
            col[code - 1] = int(40 * c) + fov
        ab[f"FOV{fov}"] = col
    ab.to_csv(tmp_path / "images_table_mix_3_results_abundance.csv",
              index=False)
    pd.DataFrame({
        "Barcodes": list(conc), "InputConcentration": list(conc.values()),
    }).to_csv(tmp_path / "images_table_mix_3.csv", index=False)

    cli_t.main([str(tmp_path), "-m", "3"])
    assert (tmp_path / "titration_mix_3.pdf").exists()

    from hiprfish_tpu.pipeline import summarize

    res = summarize.titration_correlation(
        str(tmp_path / "images_table_mix_3_results_abundance.csv"))
    assert res["slope"] > 0 and res["rvalue"] > 0.99


def test_cli_analyze_multispecies(tmp_path, rng):
    from hiprfish_tpu.cli import analyze_multispecies as cli_ms

    taxids = [564, 1718]
    expected = {564: "0101010", 1718: "1010101"}
    probe_paths = []
    for enc_set in ("B", "C", "A"):
        for t in taxids:
            n = 10
            spectra = rng.rand(n, 63) * 0.5 + 0.5
            checks = rng.randint(0, 2, (n, 4)).astype(float)
            meta = np.column_stack([
                np.array(["s"] * n), np.arange(1, n + 1),
                rng.rand(n), rng.rand(n), rng.rand(n), rng.rand(n),
                rng.rand(n), rng.rand(n), rng.randint(60, 900, n)])
            df = pd.DataFrame(np.column_stack(
                [spectra, checks,
                 np.array([expected[t]] * n)[:, None], meta]))
            df.to_csv(
                tmp_path / f"x_{enc_set}_{t}_fov_1_cell_information.csv",
                index=None, header=None)
        p = tmp_path / f"probes_{enc_set}.csv"
        pd.DataFrame({"target_taxon": taxids,
                      "code": [expected[t] for t in taxids]}).to_csv(
            p, index=False)
        probe_paths.append(str(p))

    cli_ms.main([str(tmp_path), "-p", *probe_paths])
    assert (tmp_path / "multispecies_error_rate.pdf").exists()
    assert (tmp_path
            / "multispecies_representative_cell_spectra.pdf").exists()


def test_cli_train_direct(tmp_path):
    from hiprfish_tpu.cli import train as cli_train
    from hiprfish_tpu.utils import synthetic

    ref = tmp_path / "ref"
    ref.mkdir()
    synthetic.write_reference_folder(TEN_BIT, str(ref), [5, 37, 515],
                                     cells_per_code=25, seed=0)
    cli_train.main([str(ref), "-v", "direct"])


@pytest.mark.slow
def test_cli_measure_multispecies_and_biofilm_2d(tmp_path, monkeypatch, rng):
    """The multispecies measure CLI and the biofilm CLI (-d 2, directory
    scan + probe-design taxon lookup + classifier artifact resolution)."""
    from hiprfish_tpu.cli import biofilm as cli_biofilm
    from hiprfish_tpu.cli import measure_multispecies as cli_ms
    from hiprfish_tpu.config import SEVEN_BIT
    from hiprfish_tpu.models.artifacts import save_classifier
    from hiprfish_tpu.utils import synthetic
    from tests.test_biofilm_and_3d import _quick_classifier

    codes = [1, 9, 65, 127, 34, 88]
    fov = synthetic.make_fov(SEVEN_BIT, codes, shape=(192, 192), seed=5,
                             cell_axes=(7.0, 12.0))
    folder = tmp_path / "fovs"
    folder.mkdir()
    for laser, plane in zip(SEVEN_BIT.lasers, fov["stack"]):
        np.save(folder / f"sampleA_{laser}.npy",
                np.asarray(plane, np.float32))

    monkeypatch.chdir(folder)
    names = [f"sampleA_{laser}.npy" for laser in SEVEN_BIT.lasers]
    cli_ms.main(["-i", *names, "--max_cells", "64"])
    for suffix in ("_seg.npy", "_registered.npy", "_avgint_norm.csv"):
        assert os.path.exists("sampleA" + suffix), suffix
    assert int(np.load("sampleA_seg.npy").max()) >= len(codes) - 1

    clf = _quick_classifier(codes)
    clf_path = tmp_path / "clf_7b.npz"
    save_classifier(str(clf_path), clf)
    probes = tmp_path / "probes.csv"
    pd.DataFrame({"target_taxon": [100 + i for i in range(len(codes))],
                  "code": [SEVEN_BIT.code_str(c) for c in codes]}).to_csv(
        probes, index=False)
    cli_biofilm.main([str(folder), "-p", str(probes), "-r", str(clf_path),
                      "-d", "2", "--max_cells", "64"])
    assert os.path.exists(str(folder / "sampleA_cell_information.csv"))
    assert os.path.exists(str(tmp_path / "fovs" / "taxon_color_lookup.csv")) \
        or os.path.exists(str(folder / "taxon_color_lookup.csv"))


@pytest.mark.slow
def test_cli_workflow_ecoli_end_to_end(tmp_path, monkeypatch):
    """The Snakemake-replacement driver through its CLI: config JSON ->
    measure -> classify (classifier path derived from the row by the
    filename-convention tree) -> collect, then a second run that must skip
    every stage via output freshness (Snakemake's recovery semantics)."""
    from hiprfish_tpu.cli import workflow as cli_workflow
    from hiprfish_tpu.models import train as mtrain
    from hiprfish_tpu.config import ClassifierConfig
    from hiprfish_tpu.utils import synthetic

    codes = [5, 37, 515]
    data_dir = tmp_path / "data"
    ref_folder = data_dir / "ref_1023"
    ref_folder.mkdir(parents=True)
    synthetic.write_reference_folder(TEN_BIT, str(ref_folder), codes,
                                     cells_per_code=30, seed=0)
    cfg = ClassifierConfig(simulations_per_code=120, check_train_steps=200)
    mtrain.train_excitation_adjusted_violet_derivative(
        str(ref_folder), 120, cfg, save=True)

    rows = []
    folder = data_dir / "fovs"
    folder.mkdir()
    for enc in codes[:2]:
        image_name = f"run_enc_{enc}"
        fov = synthetic.make_fov(TEN_BIT, [enc] * 6, shape=(192, 192),
                                 seed=enc, cell_axes=(9.0, 14.0))
        for laser, plane in zip(TEN_BIT.lasers, fov["stack"]):
            np.save(folder / f"{image_name}_{laser}.npy",
                    np.asarray(plane, np.float32))
        rows.append({"SAMPLE": "fovs", "IMAGES": image_name,
                     "CALIBRATION": "F", "CALIBRATION_FILENAME": "none",
                     "REFERENCE_FOLDER": ref_folder.name, "SPC": 120})
    table = tmp_path / "images_table.csv"
    pd.DataFrame(rows).to_csv(table, index=False)
    config = tmp_path / "hiprfish_config_imaging.json"
    config.write_text(json.dumps({
        "__default__": {"SCRIPTS_PATH": "", "DATA_DIR": str(data_dir)},
        "images": {"image_list_table": str(table), "image_type": "R"},
    }))

    cli_workflow.main([str(config), "--max_cells", "64"])
    results = str(table)[:-len(".csv")] + "_results.csv"
    assert os.path.exists(results)
    res = pd.read_csv(results)
    assert res.shape[0] == 2 and (res.NCells.values >= 5).all()
    # high accuracy on the easy synthetic scene
    assert (res.ErrorRate.values <= 1 / 5 + 1e-9).all()

    artifacts = [str(folder / f"run_enc_{enc}{s}") for enc in codes[:2]
                 for s in ("_avgint.csv", "_cell_ids.txt", "_seg.npy")]
    mtimes = {a: os.path.getmtime(a) for a in artifacts}
    cli_workflow.main([str(config), "--max_cells", "64"])
    for a in artifacts:     # freshness skip: nothing re-ran
        assert os.path.getmtime(a) == mtimes[a], a


def test_bench_retry_on_transient_config_failure(monkeypatch):
    """The bench orchestrator retries a failed config once in a fresh
    process (transient device-OOM cascades; see bench.py), but never
    retries timeouts and keeps the original error when the retry also
    fails."""
    import importlib.util
    import os as _os
    spec = importlib.util.spec_from_file_location(
        "bench", _os.path.join(_os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    calls = []

    def flaky(config, timeout_s=1500):
        calls.append(config)
        if len(calls) == 1:
            return {"error": "RESOURCE_EXHAUSTED"}
        return {"ms_per_fov": 1.0}

    monkeypatch.setattr(bench, "_run_config_subprocess", flaky)
    assert bench._run_config_with_retry("3d") == {"ms_per_fov": 1.0}
    assert calls == ["3d", "3d"]

    monkeypatch.setattr(bench, "_run_config_subprocess",
                        lambda c, timeout_s=1500: {"error": "3d timed out after 1500s"})
    out = bench._run_config_with_retry("3d")
    assert out["error"].startswith("3d timed out")  # no retry on timeout

    monkeypatch.setattr(bench, "_run_config_subprocess",
                        lambda c, timeout_s=1500: {"error": "boom"})
    out = bench._run_config_with_retry("3d")
    assert out == {"error": "boom", "retry_error": "boom"}


def test_cli_warmup_precompiles_engines(tmp_path, monkeypatch):
    """cli.warmup must AOT-compile the flagship signatures it names: after
    warmup at a given size, a direct fused-engine call at that size emits
    no fresh XLA compile (the contract tests/test_warmup_aot.py pins)."""
    import logging

    import jax
    import jax.numpy as jnp

    from hiprfish_tpu.cli import warmup
    from hiprfish_tpu.config import TEN_BIT, SegmentationConfig
    from hiprfish_tpu.pipeline import fused_ecoli

    monkeypatch.chdir(tmp_path)
    warmup.main(["--family", "ecoli", "--size", "96", "--max_cells", "64"])

    class _Log(logging.Handler):
        def __init__(self):
            super().__init__()
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    handler = _Log()
    logger = logging.getLogger("jax._src.dispatch")
    old = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    try:
        jax.config.update("jax_log_compiles", True)
        bounds = TEN_BIT.block_bounds
        stack = tuple(
            jnp.zeros((96, 96, bounds[i + 1] - bounds[i]), jnp.float32)
            for i in range(TEN_BIT.n_lasers))
        out = fused_ecoli.segment_ecoli_device(stack, SegmentationConfig(),
                                               64)
        jax.block_until_ready(out[0])
    finally:
        jax.config.update("jax_log_compiles", False)
        logger.removeHandler(handler)
        logger.setLevel(old)
    compiled = [m for m in handler.messages
                if "segment_ecoli_device" in m and "compil" in m.lower()]
    assert not compiled, compiled


def test_bench_exits_nonzero_when_a_config_fails(monkeypatch):
    """bench.py's orchestrator reports a failed config through its exit
    code instead of swallowing it."""
    import importlib.util
    import os as _os
    spec = importlib.util.spec_from_file_location(
        "bench", _os.path.join(_os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    results = {"headline": {"value": 1.0, "extra": {}},
               "10b": {"error": "10b exited 1: boom"},
               "3d": {"cells_found": 1}}
    monkeypatch.setattr(bench, "_run_config_subprocess",
                        lambda config, timeout_s=1500: results[config])
    monkeypatch.setenv("BENCH_CLI", "0")
    assert bench.orchestrate() == 1
    results["10b"] = {"ms_per_fov": 1.0}
    assert bench.orchestrate() == 0
