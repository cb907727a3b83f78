"""Compare the per-layer kernel times of two ``chip_smoke.py`` runs.

    python3 tools/compare_layers.py BEFORE.json AFTER.json [--limit 1.05]

Reads the ``layers`` section each run wrote (``chip_smoke.py --out``),
and for every path both runs timed (``vgg16_full``, ``resnet50_full``,
``chain_A`` ...) prints each layer's ms before and after, their ratio
and, where the after run names it, the core the layer ran on; then the
layers whose after/before ratio exceeds ``--limit``.  Format-pass rows
(``<layer>/xformat``) are inside their layer's time and are skipped.
Exits 1 when a layer the after run put on the mma core is slower than
``--limit`` times its before time.  Compare runs made in one call on one
card: the times carry no card of their own.
"""
import argparse
import json
import sys


def layers(path):
    with open(path) as f:
        run = json.load(f)
    return run["layers"], run.get("card", "")


def main() -> int:
    ap = argparse.ArgumentParser(prog="compare_layers")
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--limit", type=float, default=1.05)
    args = ap.parse_args()
    before, card_b = layers(args.before)
    after, card_a = layers(args.after)
    print(f"before: {card_b}; after: {card_a}")
    slower = []
    for path in sorted(set(before) & set(after)):
        for name, row in after[path].items():
            old = before[path].get(name)
            if old is None or row["kernel"] == "bfp_conv2d_xformat":
                continue
            ratio = row["ms"] / old["ms"]
            core = row.get("core", "?")
            print(f"{path:<14} {name:<16} {row['kernel']:<22} core={core:<4} "
                  f"{old['ms']:.4f} -> {row['ms']:.4f} ms  x{ratio:.3f}")
            if ratio > args.limit:
                slower.append((path, name, core, ratio))
    for path, name, core, ratio in slower:
        print(f"slower than x{args.limit}: {path} {name} core={core} "
              f"x{ratio:.3f}")
    return 1 if any(core == "mma" for _, _, core, _ in slower) else 0


if __name__ == "__main__":
    sys.exit(main())
