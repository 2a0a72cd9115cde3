"""PyTorch port: the sharded checkpoint plane (``horovod_tpu_torch/ckpt``)
against the reference's (``horovod_tpu/ckpt``).

* The cases of ``tests/test_ckpt.py`` on the port, with the reference's
  assertions: round trips (torch tensors, bf16 among them, and a torch
  optimizer's ``state_dict`` in place of optax's state), retention, the
  async writer (blocking bound, backpressure, a background failure), the
  sharded format (crc fail-fast, replicas, an interrupted re-commit),
  the N -> M reshard (plan, local and comm paths), the replica exchange
  over the p2p ring in 3 processes (with the native coordinator behind
  ``hvd.init``), replicate without a KV plane, the ``HOROVOD_CKPT_*``
  knobs, the metrics, ``verify_step``.
* Across the packages: the same numpy tree saved by each writes the
  same shard bytes and the same leaf and chunk tables, and restores in
  the other leaf for leaf; bf16 crosses both ways; a reference-saved
  tiny Llama restores in the port from its paths and gives the
  reference's logits; a port checkpoint passes ``tools/ckpt_inspect.py
  verify``; restoring a reference checkpoint never imports jax.

Tolerances: checkpoint bytes are exact; the Llama logits within 1e-5
(fp32, one model, two frameworks).
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ckpt import ShardedCheckpointer as JCheckpointer
from horovod_tpu.ckpt import load_manifest as jload_manifest
from horovod_tpu.models import llama as jllama
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ckpt import (
    CkptError, ShardedCheckpointer, flatten_with_paths, list_steps,
    load_manifest, plan_reshard, replica_name, row_bounds, shard_name,
    step_dir, verify_step,
)
from horovod_tpu_torch.ckpt import store as store_mod
from horovod_tpu_torch.core.config import Config
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.native.store import StoreServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    """The reference suite's mixed tree."""
    return {
        "params": {"w": np.arange(997 * 3, dtype=np.float32
                                  ).reshape(997, 3),
                   "b": np.arange(5, dtype=np.int64),
                   "scale": np.float32(2.5)},
        "tbl": [np.ones((2, 2), np.float32), np.zeros(3, np.int32)],
        "step": 7, "note": "hello", "flag": True, "none": None,
    }


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return np.asarray(x)


def _assert_trees_equal(a, b):
    """Same structure (paths and the structure record), same leaves:
    arrays in dtype and bytes, python values equal."""
    pa, la, sa = flatten_with_paths(a)
    pb, lb, sb = flatten_with_paths(b)
    assert (pa, sa) == (pb, sb)
    for x, y in zip(la, lb):
        if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
            xa, ya = _as_np(x), _as_np(y)
            assert type(xa) is type(ya)
            if isinstance(xa, torch.Tensor):
                assert xa.dtype == ya.dtype and torch.equal(xa, ya)
            else:
                assert xa.dtype == ya.dtype, (xa.dtype, ya.dtype)
                np.testing.assert_array_equal(xa, ya)
        else:
            assert x == y, (x, y)


def _by_path(tree, prefix=()):
    """``{path: leaf}`` of a nested dict (the path-fallback shape)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_path(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


class TestRoundTrip:
    def test_mixed_tree_bitexact(self, tmp_path):
        tree = _tree()
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            assert ck.save(7, tree) is True
            out = ck.restore()
        # the structure record keeps the None, the list and the scalars
        _assert_trees_equal({**tree, "params": {
            **tree["params"], "scale": np.asarray(np.float32(2.5))}}, out)
        assert out["none"] is None and isinstance(out["tbl"], list)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.int64, torch.bool])
    def test_torch_tensors_and_target(self, tmp_path, dtype):
        g = torch.Generator().manual_seed(0)
        w = (torch.randn(6, 5, generator=g) * 3).to(dtype)
        tree = {"p": w, "n": torch.tensor(1.5).to(dtype)}
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            ck.save(0, tree)
            out = ck.restore(0, target={"p": torch.zeros_like(w),
                                        "n": torch.zeros((), dtype=dtype)})
            plain = ck.restore(0)
        for k in tree:
            assert out[k].dtype == dtype and torch.equal(out[k], tree[k])
        if dtype == torch.bfloat16:
            # numpy has no bfloat16: it comes back as a torch tensor
            assert torch.equal(plain["p"], w)
        else:
            np.testing.assert_array_equal(plain["p"], w.numpy())

    def _adamw(self, seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                    torch.nn.Linear(8, 3))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2,
                                betas=(0.8, 0.95))
        for _ in range(2):
            model(torch.randn(5, 4)).square().sum().backward()
            opt.step()
        return model, opt

    def test_optimizer_state_dict_via_target(self, tmp_path):
        """A torch optimizer's state (int keys, tuples, a ``step``
        tensor) round-trips into a fresh optimizer through ``target``,
        and training resumes with the same numbers."""
        model, opt = self._adamw(0)
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            ck.save(2, {"opt": opt.state_dict(),
                        "params": model.state_dict()})
            model2, opt2 = self._adamw(1)
            out = ck.restore(target={"opt": opt2.state_dict(),
                                     "params": model2.state_dict()})
        model2.load_state_dict(out["params"])
        opt2.load_state_dict(out["opt"])
        _assert_trees_equal(opt.state_dict(), opt2.state_dict())
        x = torch.randn(5, 4)
        for m, o in ((model, opt), (model2, opt2)):
            m.zero_grad(set_to_none=True)
            m(x).square().sum().backward()
            o.step()
        for a, b in zip(model.parameters(), model2.parameters()):
            assert torch.equal(a, b)

    def test_optimizer_state_without_target_keeps_structure(
            self, tmp_path):
        _, opt = self._adamw(0)
        sd = opt.state_dict()
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            ck.save(0, sd)
            out = ck.restore()
        assert flatten_with_paths(out)[2] == flatten_with_paths(sd)[2]
        assert sorted(out["state"]) == sorted(sd["state"])
        assert out["param_groups"][0]["betas"] == (0.8, 0.95)

    def test_state_dict_order_does_not_decide_the_manifest(self, tmp_path):
        a = OrderedDict([("z", np.ones(2)), ("a", np.zeros(3))])
        b = {"a": np.zeros(3), "z": np.ones(2)}
        for name, t in (("a", a), ("b", b)):
            with ShardedCheckpointer(str(tmp_path / name),
                                     async_save=False) as ck:
                ck.save(0, t)
        ma, mb = (load_manifest(str(tmp_path / n), 0) for n in "ab")
        assert ma["leaves"] == mb["leaves"] and \
            ma["chunks"] == mb["chunks"]
        assert [e["path"] for e in ma["leaves"]] == ["a", "z"]

    def test_empty_leading_axis_and_0d(self, tmp_path):
        tree = {"empty": np.zeros((0, 4), np.float32),
                "scalar0d": np.asarray(3.25, np.float64)}
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            ck.save(0, tree)
            out = ck.restore()
        assert out["empty"].shape == (0, 4)
        assert float(out["scalar0d"]) == 3.25

    def test_restore_missing_raises(self, tmp_path):
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            with pytest.raises(FileNotFoundError):
                ck.restore()

    @pytest.mark.parametrize("target,match", [
        ({"a": np.ones(3)}, "leaves"),
        ({"a": np.ones(3), "c": np.ones(2)}, "stands where"),
        ({"a": np.ones(3, np.float32), "b": np.ones(2)}, "float64"),
        ({"a": torch.ones(4, dtype=torch.float64), "b": np.ones(2)},
         r"\[4\]"),
    ])
    def test_target_mismatch_is_clear(self, tmp_path, target, match):
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            ck.save(0, {"a": np.ones(3), "b": np.ones(2)})
            with pytest.raises(CkptError, match=match):
                ck.restore(target=target)

    def test_pyobj_pickles_read_back_safely(self, tmp_path):
        """A set rides as a pickle the restricted unpickler reads; an
        object it would not read is refused at save; a blob naming
        anything but a few builtins is refused at restore, never run."""
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            ck.save(0, {"s": {3, 1}, "x": np.ones(2)})
            assert ck.restore(0)["s"] == {1, 3}
            with pytest.raises(CkptError, match="cannot be saved"):
                ck.save(1, {"dt": torch.float32})
        import base64
        import pickle
        man = load_manifest(str(tmp_path), 0)
        man["leaves"][0]["pickle"] = base64.b64encode(
            pickle.dumps(os.getcwd)).decode()
        with open(os.path.join(step_dir(str(tmp_path), 0),
                               "MANIFEST.json"), "w") as f:
            json.dump(man, f)
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            with pytest.raises(CkptError, match="never unpickled"):
                ck.restore(0)


class TestRetention:
    def test_latest_all_steps_prune(self, tmp_path):
        with ShardedCheckpointer(str(tmp_path), max_to_keep=2,
                                 async_save=False) as ck:
            for s in (1, 2, 3):
                ck.save(s, {"x": np.full(2, float(s))})
            assert ck.latest_step() == 3
            assert ck.all_steps() == [2, 3]
            out = ck.restore()
        np.testing.assert_array_equal(out["x"], [3.0, 3.0])

    def test_save_same_step_needs_force(self, tmp_path):
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            assert ck.save(1, {"x": np.ones(2)}) is True
            assert ck.save(1, {"x": np.zeros(2)}) is False
            assert ck.save(1, {"x": np.zeros(2)}, force=True) is True
            out = ck.restore(1)
        np.testing.assert_array_equal(out["x"], [0.0, 0.0])

    def test_keep_everything_with_zero(self, tmp_path):
        with ShardedCheckpointer(str(tmp_path), max_to_keep=0,
                                 async_save=False) as ck:
            for s in range(5):
                ck.save(s, {"x": np.ones(1)})
            assert ck.all_steps() == [0, 1, 2, 3, 4]


class TestAsyncSnapshot:
    def test_async_commit_and_fence(self, tmp_path):
        tree = {"x": torch.arange(10000, dtype=torch.float32)}
        with ShardedCheckpointer(str(tmp_path), async_save=True) as ck:
            ck.save(0, tree)
            tree["x"] += 1          # the snapshot was taken at save()
            ck.wait_until_finished()
            out = ck.restore(0)
        np.testing.assert_array_equal(out["x"], np.arange(10000.0))

    def test_blocking_time_bounded_vs_sync(self, tmp_path, monkeypatch):
        """With the shard write slowed to a fixed floor, an async save()
        returns in <= 25% of the synchronous one."""
        real = store_mod.write_shard

        def slow_write(*a, **kw):
            time.sleep(0.15)
            return real(*a, **kw)

        monkeypatch.setattr(store_mod, "write_shard", slow_write)
        tree = {"x": np.arange(1 << 16, dtype=np.float32)}
        t0 = time.perf_counter()
        with ShardedCheckpointer(str(tmp_path / "s"),
                                 async_save=False) as ck:
            ck.save(0, tree)
        sync_ms = (time.perf_counter() - t0) * 1000.0
        with ShardedCheckpointer(str(tmp_path / "a"),
                                 async_save=True) as ck:
            t0 = time.perf_counter()
            ck.save(0, tree)
            blocking_ms = (time.perf_counter() - t0) * 1000.0
            ck.wait_until_finished()
            out = ck.restore(0)
        np.testing.assert_array_equal(out["x"], tree["x"])
        assert blocking_ms <= 0.25 * sync_ms, (blocking_ms, sync_ms)

    def test_depth_backpressure_bounds_inflight(self, tmp_path,
                                                monkeypatch):
        real = store_mod.write_shard

        def slow_write(*a, **kw):
            time.sleep(0.1)
            return real(*a, **kw)

        monkeypatch.setattr(store_mod, "write_shard", slow_write)
        tree = {"x": np.ones(16, np.float32)}
        with ShardedCheckpointer(str(tmp_path), async_save=True,
                                 snapshot_depth=1,
                                 max_to_keep=0) as ck:
            t0 = time.perf_counter()
            for s in range(3):
                ck.save(s, tree)
            elapsed = time.perf_counter() - t0
            ck.wait_until_finished()
            assert ck.all_steps() == [0, 1, 2]
        assert elapsed >= 0.1, elapsed

    def test_background_failure_surfaces_on_step_loop(self, tmp_path,
                                                      monkeypatch):
        def boom(*a, **kw):
            raise OSError("disk gone")

        monkeypatch.setattr(store_mod, "write_shard", boom)
        ck = ShardedCheckpointer(str(tmp_path), async_save=True)
        ck.save(0, {"x": np.ones(2)})
        with pytest.raises(CkptError, match="disk gone"):
            ck.wait_until_finished()
        ck.close()


def _save_world(root, tree, step, world, replicate_via_copy=False,
                pkg=ShardedCheckpointer):
    """An N-rank sync save in one process: the writers first, the rank-0
    committer last."""
    for r in list(range(1, world)) + [0]:
        with pkg(root, rank=r, world=world, async_save=False) as ck:
            ck.save(step, tree)
    if replicate_via_copy:
        sdir = step_dir(root, step)
        for r in range(world):
            shutil.copy(os.path.join(sdir, shard_name(r)),
                        os.path.join(sdir, replica_name(r)))


def _restore_equal(root, step, tree, **kw):
    with ShardedCheckpointer(root, async_save=False, **kw) as ck:
        out = ck.restore(step, target=tree)
    _assert_trees_equal(tree, out)


class TestShardedFormat:
    def test_every_rank_writes_only_its_shard(self, tmp_path):
        _save_world(str(tmp_path), _tree(), 3, world=4)
        sdir = step_dir(str(tmp_path), 3)
        assert sorted(os.listdir(sdir)) == ["MANIFEST.json"] + [
            shard_name(r) for r in range(4)]
        man = load_manifest(str(tmp_path), 3)
        assert man["world"] == 4
        w = next(e for e in man["leaves"] if e["path"] == "params/w")
        assert w["partition"] == "row"
        b = row_bounds(997, 4)
        rows = [c["rows"] for c in man["chunks"]["0"]
                if man["leaves"][c["leaf"]]["path"] == "params/w"]
        assert rows == [[b[0], b[1]]]

    def test_crc_corruption_fails_fast(self, tmp_path):
        _save_world(str(tmp_path), _tree(), 1, world=2)
        p = os.path.join(step_dir(str(tmp_path), 1), shard_name(1))
        raw = bytearray(open(p, "rb").read())
        raw[7] ^= 0xFF
        open(p, "wb").write(bytes(raw))
        with ShardedCheckpointer(str(tmp_path), rank=0, world=1,
                                 async_save=False) as ck:
            with pytest.raises(CkptError, match="crc32 mismatch.*damaged"):
                ck.restore(1)

    def test_missing_shard_without_replica_is_clear(self, tmp_path):
        _save_world(str(tmp_path), _tree(), 1, world=2)
        os.remove(os.path.join(step_dir(str(tmp_path), 1), shard_name(1)))
        with ShardedCheckpointer(str(tmp_path), rank=0, world=1,
                                 async_save=False) as ck:
            with pytest.raises(CkptError, match="missing"):
                ck.restore(1)

    def test_replica_recovers_lost_shard(self, tmp_path):
        tree = _tree()
        _save_world(str(tmp_path), tree, 1, world=4,
                    replicate_via_copy=True)
        os.remove(os.path.join(step_dir(str(tmp_path), 1), shard_name(2)))
        _restore_equal(str(tmp_path), 1, tree, rank=0, world=1)

    def test_corrupt_replica_and_lost_shard_still_fail(self, tmp_path):
        _save_world(str(tmp_path), _tree(), 1, world=2,
                    replicate_via_copy=True)
        sdir = step_dir(str(tmp_path), 1)
        os.remove(os.path.join(sdir, shard_name(1)))
        p = os.path.join(sdir, replica_name(1))
        raw = bytearray(open(p, "rb").read())
        raw[3] ^= 0x55
        open(p, "wb").write(bytes(raw))
        with ShardedCheckpointer(str(tmp_path), rank=0, world=1,
                                 async_save=False) as ck:
            with pytest.raises(CkptError, match="refusing to load"):
                ck.restore(1)

    def test_interrupted_recommit_swap_recovers(self, tmp_path):
        tree = _tree()
        _save_world(str(tmp_path), tree, 2, world=1)
        final = step_dir(str(tmp_path), 2)
        os.rename(final, final + ".old")     # the mid-swap crash state
        assert list_steps(str(tmp_path)) == []
        _restore_equal(str(tmp_path), None, tree, rank=0, world=1)
        assert list_steps(str(tmp_path)) == [2]

    def test_uncommitted_tmp_dir_is_invisible(self, tmp_path):
        with ShardedCheckpointer(str(tmp_path), rank=1, world=2,
                                 async_save=False) as ck:
            ck.save(9, {"x": np.ones(4)})   # writer, not committer
        assert list_steps(str(tmp_path)) == []
        with ShardedCheckpointer(str(tmp_path), rank=0, world=1,
                                 async_save=False) as ck:
            with pytest.raises(FileNotFoundError):
                ck.restore()


class TestReshard:
    @pytest.mark.parametrize("n_from,n_to", [(4, 2), (4, 3), (3, 5),
                                             (1, 4), (4, 1), (5, 5)])
    def test_plan_covers_every_target_block_exactly(self, n_from, n_to):
        sb = row_bounds(997, n_from)
        man = {"world": n_from,
               "leaves": [{"path": "w", "kind": "array",
                           "dtype": "float32", "shape": [997, 3],
                           "partition": "row"},
                          {"path": "s", "kind": "array",
                           "dtype": "int32", "shape": [],
                           "partition": "rep"}],
               "chunks": {str(r): ([{"leaf": 0, "rows": [sb[r], sb[r + 1]],
                                     "offset": 0, "nbytes": 0, "crc32": 0}]
                                   + ([{"leaf": 1, "rows": None,
                                        "offset": 0, "nbytes": 0,
                                        "crc32": 0}] if r == 0 else []))
                          for r in range(n_from)}}
        plans = plan_reshard(man, n_to)
        tb = row_bounds(997, n_to)
        for t in range(n_to):
            covered = []
            for op in (op for op in plans[t] if op["leaf"] == 0):
                lo, hi = op["rows"]
                assert sb[op["src"]] <= lo < hi <= sb[op["src"] + 1]
                covered.append((lo, hi))
            covered.sort()
            if tb[t + 1] > tb[t]:
                assert covered[0][0] == tb[t]
                assert covered[-1][1] == tb[t + 1]
                for (_, b_), (c, _) in zip(covered, covered[1:]):
                    assert b_ == c
        rep_ops = [op for t in range(n_to) for op in plans[t]
                   if op["leaf"] == 1]
        assert rep_ops == [{"leaf": 1, "src": 0, "rows": None}]

    @pytest.mark.parametrize("n_to", [1, 2, 3, 5, 8])
    def test_restore_4_rank_checkpoint_onto_m(self, tmp_path, n_to):
        tree = _tree()
        _save_world(str(tmp_path), tree, 5, world=4)
        for r in range(n_to):
            with ShardedCheckpointer(str(tmp_path), rank=r, world=n_to,
                                     async_save=False) as ck:
                out = ck.restore(5, via="local", target=tree)
            _assert_trees_equal(tree, out)

    @pytest.mark.parametrize("n_to", [2, 3])
    def test_restore_resharded_comm_path_n_to_m(self, tmp_path, n_to):
        """Plan -> per-rank chunk reads -> one allgather -> blob assembly
        for a world other than the saved one, through a barrier-backed
        fake coordinator: every rank assembles the identical full tree."""
        from horovod_tpu_torch.ckpt.reshard import restore_resharded
        from horovod_tpu_torch.ckpt.snapshot import unflatten
        tree = _tree()
        _save_world(str(tmp_path), tree, 3, world=4)
        man = load_manifest(str(tmp_path), 3)
        blobs, results, errors = {}, {}, []
        bar = threading.Barrier(n_to)

        class Comm:
            def __init__(self, rank):
                self.rank = rank

            def allgather(self, blob, tag="", max_bytes=0):
                blobs[self.rank] = blob
                bar.wait()
                out = [blobs[r] for r in range(n_to)]
                bar.wait()
                return out

        def run(r):
            try:
                results[r], _ = restore_resharded(
                    str(tmp_path), 3, man, r, n_to, comm=Comm(r), tag="t")
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(n_to)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        for r in range(n_to):
            _assert_trees_equal(tree, unflatten(man, results[r], tree))

    def test_reshard_after_lost_shard_uses_replica(self, tmp_path):
        tree = _tree()
        _save_world(str(tmp_path), tree, 5, world=4,
                    replicate_via_copy=True)
        os.remove(os.path.join(step_dir(str(tmp_path), 5), shard_name(3)))
        for r in range(2):
            with ShardedCheckpointer(str(tmp_path), rank=r, world=2,
                                     async_save=False) as ck:
                out = ck.restore(5, via="local", target=tree)
            _assert_trees_equal(tree, out)


#: one rank of the 3-process replica job: hvd.init over gloo with the
#: native KV exported, so the checkpointer runs on the coordinator
#: (bit-AND skip, commit barrier, latest_step broadcast, the comm reshard)
_REPLICA_WORKER = r"""
import os, sys, time
import numpy as np
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.ckpt import (ShardedCheckpointer, list_steps,
                                    replica_name, shard_name, step_dir)
root = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
assert basics.get_state().coordinator.size == n
tree = {"w": np.arange(101 * 2, dtype=np.float32).reshape(101, 2),
        "step": 1}
ck = ShardedCheckpointer(root, async_save=False, replicate=True)
assert (ck.rank, ck.world) == (r, n)
assert ck.save(1, tree) is True
assert ck.save(1, tree) is False          # every rank sees the commit
sdir = step_dir(root, 1)
pred = (r - 1) % n
with open(os.path.join(sdir, shard_name(pred)), "rb") as f:
    want = f.read()
with open(os.path.join(sdir, replica_name(pred)), "rb") as f:
    got = f.read()
assert want == got and len(want) > 0
assert ck.latest_step() == 1
out = ck.restore(1, via="comm")
assert np.array_equal(out["w"], tree["w"]) and out["step"] == 1
ck.close()
hvd.shutdown()
print("ok")
"""


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_replica_exchange_over_ring_with_the_coordinator(tmp_path):
    srv = StoreServer()
    port = _free_port()
    procs = []
    try:
        for r in range(3):
            env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                       HOROVOD_RANK=str(r), HOROVOD_SIZE="3",
                       HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                       HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                       HOROVOD_NATIVE_KV_ADDR="127.0.0.1",
                       HOROVOD_NATIVE_KV_PORT=str(srv.port))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _REPLICA_WORKER, str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0, 0], outs
        assert verify_step(str(tmp_path), 1)["replicas"] == 3
    finally:
        for p in procs:
            p.kill()
        srv.close()


def test_replicate_without_kv_plane_fails_fast(tmp_path, monkeypatch):
    monkeypatch.delenv("HOROVOD_NATIVE_KV_ADDR", raising=False)
    monkeypatch.delenv("HOROVOD_NATIVE_KV_PORT", raising=False)
    ck = ShardedCheckpointer(str(tmp_path), rank=1, world=2,
                             async_save=False, replicate=True)
    with pytest.raises(CkptError, match="HOROVOD_CKPT_REPLICATE"):
        ck.save(0, {"x": np.ones(2)})
    ck.close()


def test_init_connects_the_coordinator_only_with_a_kv_store(tmp_path,
                                                            monkeypatch):
    """``hvd.init`` connects the native coordinator when the job exports
    a KV store and not otherwise; a world-of-one checkpointer then runs
    its collective rounds over it."""
    from horovod_tpu_torch.core import basics
    for var in ("HOROVOD_NATIVE_KV_ADDR", "HOROVOD_NATIVE_KV_PORT"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        assert basics.get_state().coordinator is None
    finally:
        hvd.shutdown()
    srv = StoreServer()
    monkeypatch.setenv("HOROVOD_NATIVE_KV_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_NATIVE_KV_PORT", str(srv.port))
    try:
        hvd.init(device="cpu")
        coord = basics.get_state().coordinator
        assert (coord.rank, coord.size) == (0, 1)
        with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
            assert ck._coord is coord
            assert ck.save(2, {"x": np.ones(3)}) is True
            assert ck.save(2, {"x": np.ones(3)}) is False
            assert ck.latest_step() == 2
    finally:
        hvd.shutdown()
        srv.close()
    assert basics.get_state().coordinator is None


class TestConfigKnobs:
    @pytest.mark.parametrize("var", ["HOROVOD_CKPT_SNAPSHOT_DEPTH",
                                     "HOROVOD_CKPT_MAX_TO_KEEP"])
    def test_malformed_int_fails_fast(self, var, monkeypatch):
        monkeypatch.setenv(var, "soon")
        with pytest.raises(ValueError, match=var):
            Config.from_env()

    @pytest.mark.parametrize("var,value", [
        ("HOROVOD_CKPT_SNAPSHOT_DEPTH", "0"),
        ("HOROVOD_CKPT_SNAPSHOT_DEPTH", "65"),
        ("HOROVOD_CKPT_MAX_TO_KEEP", "-1")])
    def test_range_validated(self, monkeypatch, var, value):
        monkeypatch.setenv(var, value)
        with pytest.raises(ValueError, match=var):
            Config.from_env()

    def test_manager_fails_fast_on_bad_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HOROVOD_CKPT_SNAPSHOT_DEPTH", "lots")
        with pytest.raises(ValueError, match="SNAPSHOT_DEPTH"):
            ShardedCheckpointer(str(tmp_path))

    def test_knobs_parse_as_the_reference(self, monkeypatch):
        from horovod_tpu.core.config import Config as JConfig
        monkeypatch.setenv("HOROVOD_CKPT_SNAPSHOT_DEPTH", "4")
        monkeypatch.setenv("HOROVOD_CKPT_MAX_TO_KEEP", "0")
        monkeypatch.setenv("HOROVOD_CKPT_REPLICATE", "1")
        monkeypatch.setenv("HOROVOD_CKPT_AUTO_RESTORE", "true")
        c, j = Config.from_env(), JConfig.from_env()
        assert c.ckpt_snapshot_depth == j.ckpt_snapshot_depth == 4
        assert c.ckpt_max_to_keep == j.ckpt_max_to_keep == 0
        assert c.ckpt_replicate is j.ckpt_replicate is True
        assert c.ckpt_auto_restore is j.ckpt_auto_restore is True


class TestObservability:
    def test_metrics(self, tmp_path):
        from horovod_tpu_torch.obs import metrics
        R = metrics.get_registry()
        before = R.counter("hvd_ckpt_bytes_total", store_mod.CKPT_BYTES_HELP,
                           {"kind": "shard"}).value
        with ShardedCheckpointer(str(tmp_path / "ck"),
                                 async_save=False) as ck:
            ck.save(1, {"x": np.arange(64, dtype=np.float32)})
            ck.restore(1)
        assert R.get("hvd_ckpt_save_ms").count >= 1
        assert R.get("hvd_ckpt_blocking_ms").count >= 1
        assert R.get("hvd_ckpt_restore_ms").count >= 1
        assert R.get("hvd_ckpt_bytes_total",
                     {"kind": "shard"}).value - before >= 64 * 4
        assert R.get("hvd_ckpt_bytes_total", {"kind": "read"}).value \
            >= 64 * 4


class TestVerifyHelper:
    def test_verify_step_counts(self, tmp_path):
        _save_world(str(tmp_path), _tree(), 4, world=3,
                    replicate_via_copy=True)
        s = verify_step(str(tmp_path), 4)
        assert s["world"] == 3 and s["replicas"] == 3
        assert s["chunks"] > 0 and s["bytes"] > 0


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _shard_bytes(root, step, world):
    return [open(os.path.join(step_dir(root, step), shard_name(r)),
                 "rb").read() for r in range(world)]


@pytest.mark.parametrize("world", [1, 3])
def test_numpy_tree_crosses_the_packages_byte_for_byte(tmp_path, world):
    """The same tree saved by each package: the same shard bytes, the
    same leaf and chunk tables; each package restores the other's
    checkpoint leaf for leaf (the reference through its path fallback,
    the port by target and by paths)."""
    tree = _tree()
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    _save_world(port, tree, 4, world)
    _save_world(ref, tree, 4, world, pkg=JCheckpointer)
    assert _shard_bytes(port, 4, world) == _shard_bytes(ref, 4, world)
    mp, mr = load_manifest(port, 4), jload_manifest(ref, 4)
    assert mp["leaves"] == mr["leaves"] and mp["chunks"] == mr["chunks"]
    paths = [e["path"] for e in mp["leaves"]]
    with JCheckpointer(port, async_save=False) as ck:
        got = _by_path(ck.restore(4))
    with ShardedCheckpointer(ref, async_save=False) as ck:
        mine = _by_path(ck.restore(4))
        _assert_trees_equal(tree, ck.restore(4, target=tree))
    want = dict(zip(paths, flatten_with_paths(tree)[1]))
    for p in paths:
        for out in (got, mine):
            if isinstance(want[p], (np.ndarray, np.generic)):
                assert np.asarray(out[p]).dtype == np.asarray(want[p]).dtype
                assert np.asarray(out[p]).tobytes() == \
                    np.asarray(want[p]).tobytes()
            else:
                assert out[p] == want[p]


def test_bfloat16_crosses_both_ways(tmp_path):
    """A torch bf16 tensor written raw under "bfloat16" reads back in
    the reference as ml_dtypes' bfloat16, and a jax bf16 array in the
    port as a torch bf16 tensor, bit for bit."""
    g = torch.Generator().manual_seed(3)
    t = torch.randn(7, 5, generator=g).to(torch.bfloat16)
    j = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
                    jnp.bfloat16)
    with ShardedCheckpointer(str(tmp_path / "p"), async_save=False) as ck:
        ck.save(0, {"t": t})
    with JCheckpointer(str(tmp_path / "p"), async_save=False) as ck:
        back = ck.restore(0)["t"]
    assert back.dtype.name == "bfloat16"
    assert back.tobytes() == t.view(torch.int16).numpy().tobytes()
    with JCheckpointer(str(tmp_path / "r"), async_save=False) as ck:
        ck.save(0, {"j": j})
    with ShardedCheckpointer(str(tmp_path / "r"), async_save=False) as ck:
        mine = ck.restore(0)["j"]
        tgt = ck.restore(0, target={"j": torch.zeros(
            3, 4, dtype=torch.bfloat16)})["j"]
    assert mine.dtype == torch.bfloat16 and torch.equal(mine, tgt)
    assert mine.view(torch.int16).numpy().tobytes() == \
        np.asarray(j).tobytes()


def test_reference_llama_params_restore_by_paths(tmp_path):
    """A tiny flax Llama's params saved by the reference restore in the
    port from the manifest's paths (no target, never the jax treedef);
    through ``llama_from_flax`` they give the reference's logits."""
    kw = dict(vocab_size=64, num_layers=1, num_heads=4, num_kv_heads=2,
              head_dim=8, max_seq_len=32)
    jm = jllama.Llama(jllama.LlamaConfig(**kw, dtype=jnp.float32,
                                         attention_impl="reference"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    with JCheckpointer(str(tmp_path), async_save=False) as ck:
        ck.save(0, {"params": params})
    with ShardedCheckpointer(str(tmp_path), async_save=False) as ck:
        restored = ck.restore(0)["params"]
    tokens = np.random.RandomState(1).randint(0, 64, (2, 16)).astype(
        np.int32)
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        jnp.asarray(tokens)))
    model = tllama.Llama(tllama.LlamaConfig(**kw, dtype=torch.float32),
                         device="cpu")
    model.load_state_dict(convert.llama_from_flax(restored))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_port_checkpoint_passes_ckpt_inspect_verify(tmp_path):
    root = str(tmp_path)
    _save_world(root, {**_tree(), "t": torch.ones(4, 2)},
                1, world=2, replicate_via_copy=True)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "ckpt_inspect.py"),
         "verify", root], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout and "replica" in out.stdout


def test_restoring_a_reference_checkpoint_never_imports_jax(tmp_path):
    """The reference's manifest carries a pickled jax treedef; the port
    reads the checkpoint in a process where importing jax would fail."""
    tree = {"w": jnp.ones((3, 2)) * 2.0, "opt": (jnp.zeros(2), 5)}
    with JCheckpointer(str(tmp_path), async_save=False) as ck:
        ck.save(1, tree)
    assert "treedef" in jload_manifest(str(tmp_path), 1)
    code = ("import sys; sys.modules['jax'] = None\n"
            "import numpy as np\n"
            "from horovod_tpu_torch.ckpt import ShardedCheckpointer\n"
            f"ck = ShardedCheckpointer({str(tmp_path)!r}, async_save=False)\n"
            "out = ck.restore(1)\n"
            "assert np.array_equal(out['w'], np.full((3, 2), 2.0, "
            "np.float32)) and out['opt']['1'] == 5\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib',"
            " 'flax', 'horovod_tpu.')) for m, v in sys.modules.items()"
            " if v is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
