"""Write a control copy of ``flash_gqa.cu`` whose f32 tensor-core products
take one TF32 product (hi * hi) in place of the three-term split, to show
that the f32 limits catch a lost term:

    python scripts/tf32_one_product.py build/ab/one.cu
    python scripts/torch_flash_ab.py --f32 one=build/ab/one.cu   # on the card

Each three-term product (``lo*hi, hi*lo, hi*hi``: ``mma3`` on mma.sync,
which every product of the mma.sync kernels (K5 ``fwd_tf32_kernel``, K6
``dq_tf32_kernel``, K7 ``dkv_tf32_kernel``) reaches through ``mma_abt`` and
``mma_ab``, and of the D = 256 ones (``dq_tf32_wide_kernel``,
``dkv_tf32_wide_kernel``) through ``slice_abt`` and ``tile_ab``, and each run
of three ``wgmma_tf32`` lines) keeps its ``hi*hi``
product only, with the first product's accumulate flag.  With ``--tree DIR`` the copy is
written over ``DIR``'s own source instead (a checkout unpacked there), so
that ``chip_smoke.py``'s phases run on it from ``DIR``.  Fails unless every
product was found and rewritten.
"""
import argparse
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/kernels/flash_gqa/csrc/flash_gqa.cu")

MMA3 = ("  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.x, b1.x);\n"
        "  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.y, b1.y);\n"
        "  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.x, b1.x);\n")
ONE = "  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.x, b1.x);\n"
# (acc, a_lo, b_hi, flag), the A lo half from registers or (``wgmma_tf32_ss``)
# shared memory; then (acc, a_hi, b_lo, 1); then (acc, a_hi, b_hi, 1)
WGMMA3 = re.compile(
    r"wgmma_tf32(?:<\w+>|_ss)\((\w+), \w+(?:\[\w+\]|\(\w+\))?, (\w+), ([^;]+)\);\n\s*"
    r"wgmma_tf32<(\w+)>\(\1, (\w+(?:\[\w+\])?), \w+, 1\);\n\s*"
    r"wgmma_tf32<\4>\(\1, \5, \2, 1\);")


# each mma.sync kernel: the helpers through which it reaches mma3
MMA_SYNC_KERNELS = {"fwd_tf32_kernel": ("mma_abt<", "mma_ab<"),
                    "dq_tf32_kernel": ("mma_abt<", "mma_ab<"),
                    "dkv_tf32_kernel": ("mma_abt<", "mma_ab<"),
                    "dq_tf32_wide_kernel": ("slice_abt<", "tile_ab<"),
                    "dkv_tf32_wide_kernel": ("slice_abt<", "tile_ab<")}


def one_product(src):
    """``src`` with every three-term product cut to its hi*hi product."""
    assert src.count(MMA3) == 1, "mma3's three products not found"
    # mma.sync is issued in mma_tf32 alone, and mma_tf32 called in mma3 alone
    assert src.count("mma.sync.aligned") == 1 and src.count("mma_tf32(c, ") == 3
    for kernel, helpers in MMA_SYNC_KERNELS.items():  # each takes its products through mma3
        body = re.search(kernel + r"\(const float\* __restrict__ q.*?\n}", src, re.S).group(0)
        assert all(h in body for h in helpers), kernel
    out, n = WGMMA3.subn(r"wgmma_tf32<\4>(\1, \5, \2, \3);", src.replace(MMA3, ONE))
    assert n >= 1 and "wgmma_tf32<" in out, n
    # every wgmma product left is a hi*hi one
    assert not re.search(r"wgmma_tf32_ss\(\w+, |wgmma_tf32<\w+>\(\w+, \w*l(\[\w+\])?, ",
                         out), "a lo term is left"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", help="path of the copy")
    ap.add_argument("--tree", help="a checkout whose own source the copy replaces")
    args = ap.parse_args(argv)
    if (args.out is None) == (args.tree is None):
        ap.error("give the copy's path or --tree, not both")
    out = Path(args.out) if args.out else Path(args.tree) / SOURCE
    text = one_product((ROOT / SOURCE).read_text())
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(f"wrote {out}: every f32 tensor-core product one TF32 product", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
