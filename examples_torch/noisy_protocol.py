"""Noisy-setting demo (paper §8.2), through the PyTorch port: labels
flipped at 5 %/10 %, the noise-tolerant protocol still recovers a
near-clean separator with two orders less communication than centralizing
the noisy data.  Both protocols run on ``--device`` (the card by default).

Run:  PYTHONPATH=src python examples_torch/noisy_protocol.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import datasets
from repro_torch.core.protocols import baselines, two_way


def main(argv=None):
    """Print the table; return its rows as ``(noise %, method, clean-label
    accuracy %, noisy-label accuracy % or None, points, rounds)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the protocols run (cuda or cpu)")
    args = ap.parse_args(argv)
    rows = []
    for rate in (0.05, 0.10):
        shards = datasets.data3(n_per_node=500, k=2, seed=0)
        noisy = datasets.add_label_noise(shards, rate=rate)
        r = two_way.iterative_support_noisy(noisy, eps=0.05,
                                            device=args.device)
        nv = baselines.naive(noisy, device=args.device)
        Xc = np.concatenate([s[0] for s in shards])
        yc = np.concatenate([s[1] for s in shards])
        yn = np.concatenate([s[1] for s in noisy])
        pr, pn = r.classifier.predict(Xc), nv.classifier.predict(Xc)
        rows.append((100 * rate, "noisy-MAXMARG", 100 * np.mean(pr == yc),
                     100 * np.mean(pr == yn), r.comm["points"], r.rounds))
        rows.append((100 * rate, "NAIVE", 100 * np.mean(pn == yc), None,
                     nv.comm["points"], nv.rounds))
        print(f"noise {100 * rate:.0f}%:")
        print(f"  noisy-MAXMARG: clean-label acc {rows[-2][2]:5.1f}%  "
              f"noisy-label acc {rows[-2][3]:5.1f}%  "
              f"cost {r.comm['points']} points")
        print(f"  NAIVE:         clean-label acc {rows[-1][2]:5.1f}%  "
              f"cost {nv.comm['points']} points")
    return rows


if __name__ == "__main__":
    main()
