"""Row-budget retry: a file whose longest stream blows the tile estimate
must re-encode at a smaller k instead of failing."""

import numpy as np

import huffman_jax.ops.ils as ils_ops
from huffman_jax.core.ils_ref import ILS_LANES
from huffman_jax.models import IlsCodec


def test_vmem_retry_on_pathological_stream(monkeypatch):
    # Shrink the budget so the retry triggers at test-sized k (the real
    # budget would need k=8192 tiles, too slow for the CPU test run).
    monkeypatch.setattr(ils_ops, "VMEM_ROW_BUDGET", 8)
    monkeypatch.setattr(ils_ops, "MIN_K", 8)
    k = 32
    n = k * ILS_LANES
    data = np.zeros(n, np.uint8)
    rare = np.arange(1, 256, dtype=np.uint8)
    # sprinkle every rare symbol so all get long (~14-bit) codes ...
    data[::129] = rare[np.arange((n + 128) // 129) % 255]
    # ... then stream 5 (u32 words w % 1024 == 5) gets all-rare bytes -> its
    # codes, so its word count far exceeds the mean-based estimate
    u32_idx = np.arange(5, n // 4, ILS_LANES)
    byte_idx = (u32_idx[:, None] * 4 + np.arange(4)[None]).reshape(-1)
    data[byte_idx] = rare[np.arange(byte_idx.size) % 255]
    codec = IlsCodec.fit(data, k=k)
    comp = codec.encode(data)  # must retry with smaller k, not crash
    assert np.array_equal(codec.decode(comp), data)
    assert all(s.params.k < k for s in comp.sections)
