"""ATE evaluation CLI of the port: `scripts/eval_ate.py` on
`uvipslam_torch.io.evaluate.evaluate_ate`, with the same arguments and
the same JSON line (the rpg_trajectory_evaluation step of the reference
protocol, on TUM-format trajectories).

  python scripts/eval_ate_torch.py stamped_traj_estimate.txt \
      stamped_groundtruth.txt [--align sim3|se3|posyaw|none] [--max-dt s]

Prints one JSON line with ate_rmse_m and diagnostics.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from uvipslam_torch.io.evaluate import evaluate_ate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("estimate")
    ap.add_argument("groundtruth")
    ap.add_argument("--align", default="sim3",
                    choices=["sim3", "se3", "posyaw", "none"])
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)
    out = evaluate_ate(args.estimate, args.groundtruth,
                       align=args.align, max_dt=args.max_dt)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
