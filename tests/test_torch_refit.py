"""The quantized refit of one fresh topology slot against the loop it replaced.

``provisioner._refit_slot`` builds a slot's request vector as the
template's overhead plus ``k`` times each class's request, and keeps the
viable instance types that hold it with one array comparison. The oracle
below is the form it replaced: the class vector added ``k`` times, then
one ``np.all`` per viable type. Both must give the same type indices in
the same order and the same vector, bit for bit.
"""
import numpy as np
import pytest

from karpenter_core_tpu_torch.models.provisioner import _refit_slot

# resources as the quantized planes hold them: cpu in milli, memory in Mi,
# pods in units, ephemeral-storage in Gi
R = 4


def _loop_refit(overhead, class_requests, takes, it_alloc, viable):
    req_vec = overhead.copy()
    for ci, k in takes:
        for _ in range(k):
            req_vec += class_requests[ci]
    return req_vec, [
        int(t) for t in viable if np.all(req_vec <= it_alloc[t])
    ]


def _fake_400t():
    """Allocatables shaped like fake.InstanceTypes(400): type i has i+1
    cpu, 2(i+1) GiB and 10(i+1) pods, less 100m and 10 MiB reserved."""
    i = np.arange(400, dtype=np.float64)
    return np.stack([
        (i + 1) * 1000 - 100, (i + 1) * 2048 - 10, (i + 1) * 10,
        np.full(400, 20.0),
    ], axis=1)


def _case(name):
    alloc = _fake_400t()
    overhead = np.zeros(R)
    classes = np.array([
        [1500.0, 4096.0, 1.0, 0.0],
        [100.0, 100.0, 1.0, 0.0],
        [250.0, 512.0, 1.0, 1.0],
    ])
    viable = np.arange(400)
    if name == "equal_in_one_resource":
        # 3 x 1500m + 2,400m overhead = 6,900m: exactly type 6's allocatable
        overhead = np.array([2400.0, 0.0, 0.0, 0.0])
        takes = [(0, 3)]
    elif name == "one_quantum_over":
        overhead = np.array([2401.0, 0.0, 0.0, 0.0])
        takes = [(0, 3)]
    elif name == "empty_viable":
        viable = np.zeros(0, dtype=np.int64)
        takes = [(1, 4)]
    elif name == "single_viable":
        viable = np.array([7])
        takes = [(0, 2), (2, 3)]
    elif name == "single_viable_too_small":
        viable = np.array([0])
        takes = [(0, 1)]
    elif name == "sparse_viable":
        viable = np.array([3, 5, 17, 18, 250, 399])
        takes = [(1, 30), (2, 9)]
    else:
        raise KeyError(name)
    return overhead, classes, takes, alloc, viable


CASES = ["equal_in_one_resource", "one_quantum_over", "empty_viable",
         "single_viable", "single_viable_too_small", "sparse_viable"]


@pytest.mark.parametrize("name", CASES)
def test_refit_matches_per_type_loop(name):
    overhead, classes, takes, alloc, viable = _case(name)
    want_vec, want_idx = _loop_refit(overhead, classes, takes, alloc, viable)
    got_vec, got_idx = _refit_slot(overhead, classes, takes, alloc, viable)
    assert got_idx == want_idx
    assert all(type(t) is int for t in got_idx)
    assert got_vec.tobytes() == want_vec.tobytes()
    if name == "equal_in_one_resource":
        assert want_vec[0] == alloc[6, 0] and want_idx[0] == 6
    if name == "one_quantum_over":
        assert want_idx[0] == 7
    if name in ("empty_viable", "single_viable_too_small"):
        assert got_idx == []
    if name == "single_viable":
        assert got_idx == [7]


@pytest.mark.parametrize("k", [1, 2, 5000])
def test_refit_k_fold_request_is_the_repeated_sum(k):
    """A class taken k times: k * request equals the k-fold sum exactly,
    at cpu and memory quanta as the planes hold them (1m, 1 Mi)."""
    overhead = np.array([100.0, 10.0, 0.0, 0.0])
    classes = np.array([[1499.0, 4093.0, 1.0, 1.0], [3.0, 7.0, 1.0, 0.0]])
    alloc = np.stack([
        np.array([100.0 + 1499.0 * k, 10.0 + 4093.0 * k, k, k]),
        np.array([100.0 + 1499.0 * k - 1, 1e12, 1e6, 1e6]),
        np.full(R, 1e15),
    ])
    viable = np.arange(3)
    want_vec, want_idx = _loop_refit(overhead, classes, [(0, k)], alloc,
                                     viable)
    got_vec, got_idx = _refit_slot(overhead, classes, [(0, k)], alloc,
                                   viable)
    assert got_vec.tobytes() == want_vec.tobytes()
    assert got_idx == want_idx == [0, 2]
    # two classes taken k times each, in order
    takes = [(0, k), (1, k)]
    want = _loop_refit(overhead, classes, takes, alloc, viable)
    got = _refit_slot(overhead, classes, takes, alloc, viable)
    assert got[0].tobytes() == want[0].tobytes() and got[1] == want[1]


@pytest.mark.parametrize("seed", range(4))
def test_refit_random_slots(seed):
    """Random slots of the fake-400t shape: several classes, random takes
    and random viable subsets, some requests landing on a boundary."""
    rng = np.random.default_rng(seed)
    alloc = _fake_400t()
    classes = np.stack([
        rng.integers(100, 1501, 24).astype(np.float64),
        rng.integers(100, 4097, 24).astype(np.float64),
        np.ones(24), rng.integers(0, 2, 24).astype(np.float64),
    ], axis=1)
    for _ in range(50):
        takes = [(int(ci), int(rng.integers(1, 12)))
                 for ci in sorted(rng.choice(24, rng.integers(1, 4),
                                             replace=False))]
        viable = np.sort(rng.choice(400, rng.integers(0, 400),
                                    replace=False))
        overhead = np.zeros(R)
        if viable.size and rng.random() < 0.5:
            # pad the cpu so the request equals one viable type's allocatable
            vec = sum(k * classes[ci] for ci, k in takes)
            t = int(rng.choice(viable))
            overhead[0] = max(alloc[t, 0] - vec[0], 0.0)
        want = _loop_refit(overhead, classes, takes, alloc, viable)
        got = _refit_slot(overhead, classes, takes, alloc, viable)
        assert got[1] == want[1]
        assert got[0].tobytes() == want[0].tobytes()
