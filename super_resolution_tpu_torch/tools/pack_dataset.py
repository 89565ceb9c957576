"""Pack image folders into RawPack files (port of scripts/pack_dataset.py
of the JAX package; the analog of the reference's LMDB tooling,
HAT/ESC/basicsr/utils/lmdb_util.py):

    python3 -m super_resolution_tpu_torch.tools.pack_dataset \
        --gt ./DF2K_HR_sub --lq ./DF2K_LRx2_sub --out ./packs/df2k_x2

writes <out>_gt.srpk and <out>_lq.srpk, index-aligned (each folder in
sorted order) for ``RawPackPairedDataset`` (``gt_pack``, ``lq_pack``).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gt", required=True)
    parser.add_argument("--lq", default=None)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    from super_resolution_tpu_torch.data.rawpack_dataset import pack_folder

    n = pack_folder(args.gt, args.out + "_gt.srpk")
    print(f"packed {n} GT images -> {args.out}_gt.srpk")
    if args.lq:
        n2 = pack_folder(args.lq, args.out + "_lq.srpk")
        print(f"packed {n2} LQ images -> {args.out}_lq.srpk")
        if n != n2:
            raise SystemExit("gt / lq counts differ: the packs are not "
                             "index-aligned")


if __name__ == "__main__":
    main()
