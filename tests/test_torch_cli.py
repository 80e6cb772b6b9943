"""The port's CLI (``python -m wfa_tpu_torch.cli``) against the golden score
files, as tests/test_cli.py holds wfa_tpu's CLI."""
import subprocess
import sys
from pathlib import Path

from wfa_tpu_torch.cli import main

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


def test_cli_errors_and_unsupported_flags():
    seq = str(DATA / "wfa.utest.seq")
    assert main(["-g", "1,2,1"]) == 1                        # no input file
    assert main(["-i", seq, "-e", "0"]) == 1                 # bad max error
    assert main(["-i", seq, "-B", "-3"]) == 1                # bad band
    assert main(["-i", seq, "-n", "1", "-g", "1,2"]) == 1    # bad penalties
    assert main(["-i", seq, "-n", "1", "-x"]) == 1           # CIGAR: not yet
    assert main(["-i", seq, "-n", "1", "--profile", "t"]) == 1
