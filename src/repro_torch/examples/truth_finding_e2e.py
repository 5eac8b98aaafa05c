"""End-to-end scalable fusion on a Book-CS-scale synthetic dataset:
PAIRWISE vs INDEX vs HYBRID vs INCREMENTAL — quality identical, time falls
by orders of magnitude (the paper's Tables VI + VII in one script).

  PYTHONPATH=src python -m repro_torch.examples.truth_finding_e2e \
      [--sources N] [--items N] [--rounds N] [--device cpu]
"""
import argparse
import time

from repro_torch.core import CopyConfig, fusion_accuracy, truth_finding
from repro_torch.data.claims import SyntheticSpec, synthetic_claims


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sources", type=int, default=400)
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = CopyConfig(alpha=0.1, s=0.8, n=50.0)
    spec = SyntheticSpec(n_sources=args.sources, n_items=args.items,
                         coverage="book", n_cliques=args.sources // 40 + 3,
                         clique_size=3, clique_items=14, seed=0)
    sc = synthetic_claims(spec)
    print(f"dataset: {args.sources} sources × {args.items} items, "
          f"{len(sc.copies)} planted copying pairs")

    results = {}
    planted = {(min(a, b), max(a, b)) for a, b in sc.copy_edges}
    for detector in ("pairwise", "index", "hybrid", "incremental"):
        t0 = time.time()
        fus = truth_finding(sc.dataset, cfg, detector=detector,
                            max_rounds=args.rounds, device=args.device)
        dt = time.time() - t0
        acc = fusion_accuracy(fus, sc.dataset, sc.true_values)
        rec = len(fus.detection.copying_pairs() & planted) / len(planted)
        results[detector] = (dt, fus.detect_time_s, acc, rec)
        print(f"  {detector:<12} total={dt:6.1f}s "
              f"detect={fus.detect_time_s:6.1f}s fusion_acc={acc:.3f} "
              f"planted_recall={rec:.2f} rounds={fus.rounds}")

    base = results["pairwise"][1]
    for d, (_, dt, _, _) in results.items():
        if d != "pairwise":
            print(f"  {d}: copy-detection time ↓ {1 - dt / base:.1%} vs "
                  f"PAIRWISE")
    return results


if __name__ == "__main__":
    main()
