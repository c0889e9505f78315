"""The oracle edit demos and the converged-recon quality run (counterparts of tools/demo_oracle_*.py and
tools/quality_run_shearwarp.py), run with `python -m`."""
