"""The benchmark's plain reference: plain PyTorch and Python, nothing of
the program (``wfa.py``: distances; ``cigar.py``: a CIGAR's replay and
cost)."""
