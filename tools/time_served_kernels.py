"""Time two served-path CUDA kernels of a checkout, for A/B runs on a card.

    python3 tools/time_served_kernels.py CHECKOUT LABEL

Imports ``repro_torch`` from ``CHECKOUT/src`` (this tree, or a
``git archive`` of another commit unpacked elsewhere), builds its
kernels, and prints one line with CUDA-event times of the weight-prequant
matmul at VGG16 fc6's shape (8x25088 @ 25088x4096) and the weight-prequant
conv at conv3_2's (8x56x56x256 -> 256), block 128, L 8, seeded inputs.
Run it for two checkouts in turns in one process tree on one card
(A, B, B, A) to compare them; needs a CUDA card and nvcc.
"""
import os
import sys

import torch


def main() -> int:
    checkout, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.join(os.path.abspath(checkout), "src"))
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.core.prequant import prequant_conv_leaf, prequant_leaf
    from repro_torch.kernels import bfp_conv as KC
    from repro_torch.kernels import bfp_matmul as KM

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn(8, 25088, generator=g)).to(dev)
    w = prequant_leaf((torch.randn(25088, 4096, generator=g) * 0.009)
                      .to(dev), PALLAS_TILED)
    xc = torch.relu(torch.randn(8, 56, 56, 256, generator=g)).to(dev)
    wc = prequant_conv_leaf((torch.randn(3, 3, 256, 256, generator=g)
                             * 0.03).to(dev), PALLAS_TILED)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    fc6 = ms(lambda: KM.bfp_matmul_prequant(x, w["m"], w["s"], l_i=8,
                                            l_w=8, bk=128), 50)
    conv = ms(lambda: KC.bfp_conv2d_prequant(xc, wc["m"], wc["s"], l_i=8,
                                             l_w=8, bk=128), 20)
    card = torch.cuda.get_device_name(0)
    print(f"{label} fc6 {fc6:.4f} ms conv3_2 {conv:.4f} ms  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
