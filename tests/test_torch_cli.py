"""The port's CLI (``python -m wfa_tpu_torch.cli``) against the golden score
files, as tests/test_cli.py holds wfa_tpu's CLI."""
import logging
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from wfa_tpu.cli import main as tpu_main
from wfa_tpu_torch.cli import main

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"


def golden_scores(tag):
    path = DATA / "results" / f"test.score.affine.{tag}.alg"
    return [line.split()[0] for line in path.read_text().splitlines() if line.strip()]


def out_scores(path):
    return [
        line.split("\t")[0]
        for line in Path(path).read_text().splitlines()
        if line.strip()
    ]


def test_cli_module_golden_prefix(tmp_path):
    out = tmp_path / "res.out"
    subprocess.run(
        [sys.executable, "-m", "wfa_tpu_torch.cli",
         "-i", str(DATA / "wfa.utest.seq"), "-n", "100", "-g", "1,2,1",
         "-e", "10000", "--backend", "torch", "-o", str(out)],
        cwd=ROOT, check=True, timeout=300,
    )
    assert out_scores(out) == golden_scores("p0")[:100]


def test_cli_low_max_error_banded_check_and_print(capsys):
    """-e 25 sends pairs to the CPU fallback; -B auto -c reports recall; -p
    prints the scores to stderr."""
    rc = main([
        "-i", str(DATA / "wfa.utest.seq"), "-n", "40", "-g", "5,3,2",
        "-e", "25", "-b", "11", "-c", "-p", "--backend", "torch",
    ])
    assert rc == 0
    err = capsys.readouterr().err
    assert "correct=40 incorrect=0" in err
    lines = [ln for ln in err.splitlines() if ln.startswith("-") or ln.startswith("0\t")]
    assert [ln.split("\t")[0] for ln in lines] == golden_scores("p2")[:40]
    rc = main([
        "-i", str(DATA / "wfa.utest.seq"), "-n", "20", "-B", "auto", "-c",
        "--backend", "torch",
    ])
    assert rc == 0
    assert "recall=" in capsys.readouterr().err


def test_cli_output_verbose(tmp_path):
    out = tmp_path / "res.out"
    assert main([
        "-i", str(DATA / "wfa.utest.seq"), "-n", "5", "-g", "1,2,1",
        "-O", "-o", str(out), "--backend", "torch",
    ]) == 0
    for line in out.read_text().splitlines():
        cols = line.split("\t")
        assert len(cols) == 4 and cols[1] == ""
        assert set(cols[2]) <= set("ACGTNacgtn")


def test_cli_errors_and_unsupported_flags(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = str(DATA / "wfa.utest.seq")
    assert main(["-g", "1,2,1"]) == 1                        # no input file
    assert main(["-i", seq, "-e", "0"]) == 1                 # bad max error
    assert main(["-i", seq, "-B", "-3"]) == 1                # bad band
    assert main(["-i", seq, "-n", "1", "-g", "1,2"]) == 1    # bad penalties
    assert main(["-i", seq, "-n", "1"]) == 1                 # auto: no card
    assert main(["-i", seq, "-n", "1", "--backend", "cuda"]) == 1


def test_cli_warns_on_a_high_automatic_max_error(caplog):
    """wfa_tpu/cli.py:148-152: with no -e, the automatic max_error (10% of
    the first pair's longer read, 101 bases here, times the largest
    penalty) past 8000 draws a warning; 8000 does not."""
    seq = str(DATA / "wfa.utest.seq")
    warned = {}
    for x in (800, 801):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="wfa_tpu_torch"):
            assert main(["-i", seq, "-n", "1", "-g", f"{x},6,2",
                         "--backend", "torch"]) == 0
        warned[x] = [r.getMessage() for r in caplog.records
                     if r.levelno == logging.WARNING]
    assert warned[800] == []
    assert warned[801] == [
        "Automatically generated maximum error is very high; consider "
        "limiting it with '-e'."]


# The -x cases of tests/test_cli.py:53-110, run against both CLIs; the
# port's on the plain engine (--backend torch).
CLIS = {"wfa_tpu": (tpu_main, []), "wfa_tpu_torch": (main, ["--backend", "torch"])}


@pytest.mark.parametrize("which", sorted(CLIS))
def test_cli_cigar_check(tmp_path, capsys, which):
    """-x -c: CIGARs self-check against the exact oracle (correct=N)."""
    run, extra = CLIS[which]
    out = tmp_path / "res.out"
    rc = run([
        "-i", str(DATA / "wfa.utest.seq"), "-n", "50", "-g", "1,2,1",
        "-e", "100", "-x", "-c", "-o", str(out), *extra,
    ])
    assert rc == 0
    assert "correct=50 incorrect=0" in capsys.readouterr().err
    lines = Path(out).read_text().splitlines()
    assert len(lines) == 50
    assert all(len(line.split("\t")) >= 2 and line.split("\t")[1]
               for line in lines)
    assert [line.split("\t")[0] for line in lines] == golden_scores("p0")[:50]


def test_cli_cigar_output_verbose_equal_between_clis(tmp_path):
    """-x -O: four columns, and the two CLIs write the same file."""
    outs = {}
    for which, (run, extra) in CLIS.items():
        out = tmp_path / f"{which}.out"
        assert run([
            "-i", str(DATA / "wfa.utest.seq"), "-n", "5", "-g", "1,2,1",
            "-e", "25", "-x", "-O", "-o", str(out), *extra,
        ]) == 0
        outs[which] = out.read_text()
        for line in outs[which].splitlines():
            cols = line.split("\t")
            assert len(cols) == 4 and cols[1]
            assert set(cols[2]) <= set("ACGTNacgtn")
            assert set(cols[3]) <= set("ACGTNacgtn")
    assert outs["wfa_tpu"] == outs["wfa_tpu_torch"]


def _checker(name):
    """tools/<name>.py as a module (the tools directory is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_torch_check_cigars_counts_as_check_cigars(tmp_path, capsys):
    """The port's CIGAR checker and tools/check_cigars.py count the same
    correct and incorrect lines of the port's CLI output, as written and
    with two lines spoiled (a score, a CIGAR)."""
    out = tmp_path / "res.out"
    seq = str(DATA / "wfa.utest.seq")
    assert main(["-i", seq, "-n", "20", "-g", "1,2,1", "-e", "100", "-x",
                 "-o", str(out), "--backend", "torch"]) == 0
    capsys.readouterr()
    lines = out.read_text().splitlines()
    spoiled = tmp_path / "spoiled.out"
    score, cigar = lines[3].split("\t")[:2]
    lines[3] = f"{int(score) - 1}\t{cigar}"
    score, cigar = lines[7].split("\t")[:2]
    lines[7] = f"{score}\t1I{cigar}"
    spoiled.write_text("\n".join(lines) + "\n")
    for path, want in ((out, "correct=20 incorrect=0"), (spoiled, "correct=18 incorrect=2")):
        counts = []
        for name in ("check_cigars", "torch_check_cigars"):
            rc = _checker(name).main([str(path), "--seq", seq, "-g", "1,2,1"])
            counts.append((rc, capsys.readouterr().out.strip()))
        assert counts[0] == counts[1] == (int(path == spoiled), want)
