"""Prefetching sequence loader for benchmark / video pipelines (port of ``optical_flow_tpu/io/loader.py``).

Host I/O (PNG decode, .flo parsing) overlaps with device compute: a
background thread pool decodes upcoming items while the card runs the
current one.  numpy only.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Tuple

from optical_flow_tpu_torch.io.flo import read_flow_file


class PrefetchLoader:
    """Iterate (im1, im2, tu, tv) tuples with background prefetch.

    Args:
        items: sequence of (seq_name, frame_index) pairs.
        data_dir: Middlebury data directory (see :func:`read_flow_file`).
        prefetch: number of items decoded ahead of consumption.
    """

    def __init__(
        self,
        items: Iterable[Tuple[str, int]],
        data_dir: Optional[str] = None,
        prefetch: int = 2,
    ):
        self.items: List[Tuple[str, int]] = list(items)
        self.data_dir = data_dir
        self.prefetch = max(1, int(prefetch))

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator:
        with ThreadPoolExecutor(max_workers=self.prefetch) as pool:
            futures = [
                pool.submit(read_flow_file, seq, idx, self.data_dir)
                for seq, idx in self.items[: self.prefetch]
            ]
            next_submit = self.prefetch
            for i in range(len(self.items)):
                result = futures[i % self.prefetch].result()
                if next_submit < len(self.items):
                    seq, idx = self.items[next_submit]
                    futures[next_submit % self.prefetch] = pool.submit(
                        read_flow_file, seq, idx, self.data_dir
                    )
                    next_submit += 1
                yield result


def middlebury_loader(sequences: Iterable[str], data_dir: Optional[str] = None,
                      prefetch: int = 2) -> PrefetchLoader:
    """Loader over the standard frame-10 pairs of the given sequences."""
    return PrefetchLoader([(s, 10) for s in sequences], data_dir, prefetch)
