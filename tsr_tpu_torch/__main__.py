"""CLI hub: ``python -m tsr_tpu_torch <command> [args...]``.

The same command names as ``python -m tsr_tpu``, each running the port's
own copy of a numbered script under ``tsr_tpu_torch/scripts/``. Every
command runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import runpy
import sys
from pathlib import Path

SCRIPTS = Path(__file__).resolve().parent / "scripts"

COMMANDS = {
    "download": "01_download_data.py",
    "gen-noise": "02_gen_noise.py",
    "gen-blur": "03_gen_blur.py",
    "gen-fog": "04_gen_fog.py",
    "gen-compound": "16_gen_compound_data.py",
    "train-judge": "05_train_baseline.py",
    "eval-baseline": "06_test_baseline.py",
    "train-restorer": "07_train_restoration.py",
    "train-restorer-advanced": "07_train_restoration_advanced.py",
    "restore": "08_run_inference.py",
    "eval-restoration": "09_test_baseline.py",
    "visualize": "10_visualize_result.py",
    "hidden-states": "11_visualize_hidden_states.py",
    "embeddings": "12_generate_umap_pt.py",
    "stress-test": "13_pipeline_stress_test.py",
    "train-unified": "14_train_unified_advanced.py",
    "demo-unified": "15_test_unified.py",
    "restore-unified": "17_run_unified_inference.py",
    "eval-unified": "18_test_unified_benchmark.py",
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m tsr_tpu_torch <command> [args...]\n\n"
              "commands:")
        for name, script in COMMANDS.items():
            print(f"  {name:<24} -> tsr_tpu_torch/scripts/{script}")
        return 0 if len(sys.argv) >= 2 else 1
    cmd = sys.argv[1]
    if cmd not in COMMANDS:
        print(f"unknown command '{cmd}' (see python -m tsr_tpu_torch --help)")
        return 1
    script = SCRIPTS / COMMANDS[cmd]
    sys.argv = [str(script)] + sys.argv[2:]
    runpy.run_path(str(script), run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
