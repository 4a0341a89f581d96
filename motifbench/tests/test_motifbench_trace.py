"""The profiled slice's arithmetic on a hand-made trace: the union of
device intervals, operations picked by name and by launching function,
the idle gaps by host function."""

import pytest

from motifbench import trace


def events():
    main = 7
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.RANGE, "ts": 0, "dur": 100, "tid": main},
        {"ph": "X", "cat": "python_function", "name": "ops/multi.py(601): compact_candidates",
         "ts": 10, "dur": 10, "tid": main},
        {"ph": "X", "cat": "python_function", "name": "numpy/_core/numeric.py(324): full",
         "ts": 60, "dur": 30, "tid": main},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1,
         "tid": main, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30, "dur": 1,
         "tid": main, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "void at::native::reduce_kernel<512>(int)",
         "ts": 20, "dur": 20, "args": {"correlation": 1, "device": 0}},
        {"ph": "X", "cat": "kernel", "name": "mma_kernel<false, 1>", "ts": 30, "dur": 20,
         "args": {"correlation": 2, "device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 95,
         "dur": 10, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "other card", "ts": 20, "dur": 50,
         "args": {"device": 1}},
        {"ph": "X", "cat": "kernel", "name": "before", "ts": -50, "dur": 10, "args": {"device": 0}},
    ]


def test_slice_arithmetic():
    s = trace.Slice(events(), [1000, 2000])
    assert s.window_s == pytest.approx(100e-6)
    # [20, 50) and [95, 100) inside the range
    assert s.busy_s == pytest.approx(35e-6)
    assert [o["name"] for o in s.select(callers=[r"compact_candidates$"])] == [
        "at::native::reduce_kernel<512>"]
    assert [o["name"] for o in s.select(kernels=[r"^mma_kernel"])] == ["mma_kernel<false, 1>"]
    assert s.seconds(s.select(kernels=[r"HtoD"], cats=("gpu_memcpy",))) == pytest.approx(10e-6)
    gaps = dict(s.idle_gaps())
    assert gaps["numpy/_core/numeric.py(324): full"] == pytest.approx(45e-6)
    assert gaps["ops/multi.py(601): compact_candidates"] == pytest.approx(20e-6)
    assert s.top_ops()[0][0] in ("at::native::reduce_kernel<512>", "mma_kernel<false, 1>")


def test_union_counts_overlaps_once():
    assert trace.union([(0, 10), (5, 15), (20, 25)]) == 20
