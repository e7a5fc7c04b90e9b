"""LMDB dataset builder CLI.

Counterpart of `scenedreamer_tpu/cli/build_db.py` (reference
`scripts/build_lmdb.py` + `imaginaire/utils/lmdb.py:56-216`), with its
flags and defaults: a folder tree {data_root}/{images,seg_maps}/... into
paired raw-bytes databases keyed by relative path (`data/lmdb_utils.py`:
the real LMDB format where the `lmdb` package is installed, else its
sqlite substitute), which `PairedImageDataset(dataset_type='lmdb')`
reads.

Usage:
    python -m scenedreamer_tpu_torch.cli.build_db --data_root data/lhq_raw \
        --output_root data/lhq_lmdb/train
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data_root', required=True)
    p.add_argument('--output_root', required=True)
    p.add_argument('--data_types', nargs='+', default=['images', 'seg_maps'])
    a = p.parse_args(argv)
    from scenedreamer_tpu_torch.data.lmdb_utils import build_paired_lmdbs
    n = build_paired_lmdbs(a.data_root, a.output_root, tuple(a.data_types))
    print(f'wrote {n} paired entries to {a.output_root}')


if __name__ == '__main__':
    main()
