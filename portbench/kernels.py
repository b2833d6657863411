"""The segment-sum kernels timed at a cell's own shapes, after warm-up.

K1 (``ops.segments.segment_sums`` with float columns, the fixed-order path)
at the snapshot's broker call, and K2 (the same entry with bool columns only,
the integer path) at the snapshot's rack-count call, each built from the
cell's first input as the program's ``analyzer.context.take_snapshot`` builds
it: one state's call, or a stack's lanes in one call (each lane's ids offset
past the previous lanes' segments).  The placement is the input's own, the
one each solve starts from.

A call is timed with CUDA events over back-to-back calls replayed from one
CUDA graph, so the host's cost of a call is left out and the time is the
device's.  The bytes are counted from the shapes (``peaks.segment_sum_bytes``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from portbench import peaks
from portbench.traffic.scenario import broker_bucket

CALLS = 50
REPLAYS = 5


def _lane_ids(ids: np.ndarray, segments: int) -> np.ndarray:
    """[L, n] ids as one call's: lane i's segment s becomes ``i * segments + s``."""
    lanes = np.arange(ids.shape[0], dtype=np.int64)[:, None] * segments
    return (ids + lanes).reshape(-1).astype(np.int32)


def snapshot_calls(lanes: Sequence[Mapping]) -> Dict[str, dict]:
    """The K1 broker call and the K2 rack-count call of a snapshot of
    ``lanes`` (one state, or a stack's lanes): host columns, ids, segments."""
    L = len(lanes)
    rb = np.stack([a["replica_broker"] for a in lanes]).astype(np.int64)
    rp = np.stack([a["replica_partition"] for a in lanes]).astype(np.int64)
    valid = np.stack([a["replica_valid"] for a in lanes])
    base = np.stack([a["base_load"] for a in lanes])
    delta = np.stack([a["leadership_delta"][a["replica_partition"]] for a in lanes])
    lead = np.stack([a["partition_leader"][a["replica_partition"]] == np.arange(a["replica_partition"].shape[0])
                     for a in lanes]) & valid
    alive = np.stack([a["broker_alive"][a["replica_broker"]] for a in lanes])
    rack = np.stack([a["broker_rack"][a["replica_broker"]] for a in lanes]).astype(np.int64)
    B = lanes[0]["broker_rack"].shape[0]
    bucket = B if L > 1 else broker_bucket(B)
    racks = int(lanes[0]["num_racks"])
    P = lanes[0]["partition_topic"].shape[0]
    eff = np.where(valid[..., None], base + np.where(lead[..., None], delta, 0), 0).astype(np.float32)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
    k1_cols = [
        flat(eff), flat(valid), flat(lead),
        flat(np.where(valid, base[..., 2] + delta[..., 2], 0).astype(np.float32)),
        flat(np.where(lead, eff[..., 1], 0).astype(np.float32)),
        flat((valid & ~alive).astype(np.float32)),
    ]
    return {
        "k1": dict(columns=k1_cols, ids=_lane_ids(rb, bucket), segments=L * bucket,
                   kinds=[("f32", 4), ("bool", 1), ("bool", 1), ("f32", 1), ("f32", 1), ("f32", 1)]),
        "k2": dict(columns=[flat(valid)], ids=_lane_ids(rp * racks + rack, P * racks), segments=L * P * racks,
                   kinds=[("bool", 1)]),
    }


def device_seconds(fn: Callable[[], object]) -> float:
    """The device time of one call of ``fn``: ``CALLS`` calls captured in one
    CUDA graph, replayed ``REPLAYS`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # outside the capture: the call's scratch for this stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / (CALLS * REPLAYS)
    graph.reset()
    return seconds


def roofline(run, which: str) -> Dict[str, float]:
    """Time ``which`` (``k1`` or ``k2``) at the cell's shape: its device
    seconds a call, its bytes and its share of the bytes roofline (%)."""
    from cruise_control_tpu_torch.ops.segments import segment_sums

    call = snapshot_calls(run.inputs[0].lanes)[which]
    dev = run.device
    cols = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in call["columns"]]
    ids = torch.from_numpy(call["ids"]).to(dev)
    seconds = device_seconds(lambda: segment_sums(cols, ids, call["segments"]))
    nbytes = peaks.segment_sum_bytes(int(ids.shape[0]), call["segments"], call["kinds"])
    return {"seconds": seconds, "bytes": nbytes, "pct": peaks.roofline_pct(nbytes, seconds)}
