"""Write the index fixture that the PyTorch port's check on the GPU loads.

A GPU host running the port need not have JAX, so the multi-shard
fixture is built by the JAX package and committed: the ``hot_term_index`` of
tests/conftest.py (``build_zipfian_index()``), partitioned at K=4 by
``repro.dist.sharding.partition_index`` (its hot term is split by doc
range, so lookups route per pair) and written by ``repro.ckpt.
save_index``.  ``chip_smoke.py`` loads it with ``repro_torch.ckpt.
load_index``; tests/test_torch_index.py regenerates it and checks it
against the committed files.

Run from the repository root:
    PYTHONPATH=src python tests/data/make_torch_fixtures.py
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
HOT_TERM_K4 = os.path.join(HERE, "torch_hot_term_k4")


def write_hot_term_k4(path: str) -> str:
    from repro.ckpt import save_index
    from repro.data.synth_corpus import build_zipfian_index
    from repro.dist.sharding import partition_index

    p = partition_index(build_zipfian_index(), 4)
    if p.split_term is None:
        raise RuntimeError("the hot-term corpus must split a term at K=4")
    return save_index(path, p)


if __name__ == "__main__":
    print(write_hot_term_k4(sys.argv[1] if len(sys.argv) > 1
                            else HOT_TERM_K4))
