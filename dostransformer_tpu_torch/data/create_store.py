"""Raw-data ingestion: fold per-material JSON files into pickle stores.

Counterpart of dostransformer_tpu/data/create_store.py (the reference's
data/create_pickle.py:6-41), the same stores: one JSON file per material
under two raw directories becomes a dict keyed by Materials Project id,
``dos.pkl`` (the file name minus its 9-character suffix) and ``mp.pkl``
(keyed by response[0].material_id). A file that cannot be read or parsed is
counted and skipped, as the reference's bare ``except`` does. The stores feed
:func:`dostransformer_tpu_torch.data.featurize_edos.load_dataset`.

    python -m dostransformer_tpu_torch.data.create_store --dos_raw raw/dos_ft \
        --mp_raw raw/mpdata --dos_out dos.pkl --mp_out mp.pkl
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Tuple


def create_dos_store(raw_dir: str, out_path: str,
                     strip_suffix_len: int = 9) -> Tuple[int, int]:
    """raw DOS JSONs -> {mp_id: record} pickle. Returns (total, ok)."""
    files = os.listdir(raw_dir)
    store = {}
    for name in files:
        # filenames shorter than the suffix would key as "" (or garble) and
        # silently collide; count them as failures like unreadable files
        if len(name) <= strip_suffix_len:
            continue
        key = name[:-strip_suffix_len] if strip_suffix_len > 0 else name
        try:
            with open(os.path.join(raw_dir, name)) as f:
                store[key] = json.load(f)
        except Exception:
            # the reference tolerates ANY per-file failure (bare `except:
            # pass`, create_pickle.py) — e.g. a binary stray file raising
            # UnicodeDecodeError must be skipped, not abort the ingestion
            pass
    with open(out_path, "wb") as f:
        pickle.dump(store, f)
    print(f"DOS store: total {len(files)} | ok {len(store)} | "
          f"fail {len(files) - len(store)}")
    return len(files), len(store)


def create_mp_store(raw_dir: str, out_path: str) -> Tuple[int, int]:
    """raw MP API responses -> {material_id: response[0]} pickle."""
    files = os.listdir(raw_dir)
    store = {}
    for name in files:
        try:
            with open(os.path.join(raw_dir, name)) as f:
                rec = json.load(f)["response"][0]
                store[rec["material_id"]] = rec
        except Exception:
            # reference-equivalent tolerance (bare except in
            # create_pickle.py): a top-level JSON array raises TypeError,
            # a binary file UnicodeDecodeError — all count as failures
            pass
    with open(out_path, "wb") as f:
        pickle.dump(store, f)
    print(f"MP store: total {len(files)} | ok {len(store)} | "
          f"fail {len(files) - len(store)}")
    return len(files), len(store)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("create_store")
    p.add_argument("--dos_raw", default="./raw/dos_ft")
    p.add_argument("--mp_raw", default="./raw/mpdata")
    p.add_argument("--dos_out", default="dos.pkl")
    p.add_argument("--mp_out", default="mp.pkl")
    args = p.parse_args(argv)
    create_dos_store(args.dos_raw, args.dos_out)
    create_mp_store(args.mp_raw, args.mp_out)


if __name__ == "__main__":
    main()
