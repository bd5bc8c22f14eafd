"""Two faults of the port's unsigned keys that showed once the type set
existed, each against the JAX package:

* uint64 order: the port stores uint64 as its int64 bits, and its sort
  key ordered those bits as signed, so values at and above 2**63 sorted
  before 0. They order last now, as unsigned values do in the reference.
* the unsigned join kind: the join's direct single-key path had no
  unsigned kind, so a uint64 key joined to an int64 one took the direct
  path. It takes the grouper path now, as in the reference, where an
  int64 -1 and a uint64 2**64 - 1 share one equality word and match.
"""

import numpy as np

import arrow_tpu as at
import arrow_tpu.acero as jacero
import arrow_tpu_torch.acero as tacero
from arrow_tpu.table import Table
from arrow_tpu_torch.compute import join
from arrow_tpu_torch.device.column import batch_from_numpy
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

U64 = np.array([2 ** 63, 5, 2 ** 64 - 1, 0, 2 ** 63 - 1, 2 ** 63 + 9] * 30,
               dtype=np.uint64)


def _src(mod, t):
    return mod.Declaration("table_source", mod.TableSourceNodeOptions(t))


def test_uint64_sorts_unsigned():
    valid = np.arange(len(U64)) % 7 != 3
    port = batch_from_numpy([("k", "uint64", U64, valid, None)], len(U64),
                            device="cpu")
    ref = Table.from_pydict({"k": at.array(
        [int(v) if ok else None for v, ok in zip(U64, valid)], at.uint64())})

    def plan(mod, t):
        return mod.Declaration("order_by", mod.OrderByNodeOptions(
            [("k", "ascending")]), inputs=[_src(mod, t)])
    got = plan(tacero, port).to_table().to_pydict()["k"]
    want = plan(jacero, ref).to_table().to_pydict()["k"]
    assert got == want
    live = [v for v in got if v is not None]
    assert live == sorted(live) and live[-1] == 2 ** 64 - 1


def test_uint64_to_int64_join_takes_the_grouper_path():
    n = 90
    pk = np.array([-1, 3, 2 ** 62] * (n // 3), dtype=np.int64)
    bk = np.array([2 ** 64 - 1, 3, 2 ** 63] * (n // 3), dtype=np.uint64)
    pv = np.arange(n, dtype=np.int64)
    probe = batch_from_numpy([("pk", "int64", pk, None, None),
                              ("pv", "int64", pv, None, None)], n,
                             device="cpu")
    build = batch_from_numpy([("bk", "uint64", bk, None, None),
                              ("bv", "int64", pv, None, None)], n,
                             device="cpu")
    assert join._direct_key_kind(build.column("bk")) == "u"
    assert not join._use_direct_single_key([build.column("bk")],
                                           [probe.column("pk")])
    rprobe = Table.from_pydict({"pk": at.array(pk.tolist(), at.int64()),
                                "pv": at.array(pv.tolist(), at.int64())})
    rbuild = Table.from_pydict({"bk": at.array([int(v) for v in bk],
                                               at.uint64()),
                                "bv": at.array(pv.tolist(), at.int64())})

    def plan(mod, p, b):
        return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
            "inner", left_keys=["pk"], right_keys=["bk"]),
            inputs=[_src(mod, p), _src(mod, b)])
    got = plan(tacero, probe, build).to_table().to_pydict()
    want = plan(jacero, rprobe, rbuild).to_table().to_pydict()
    assert got == want
    assert -1 in got["pk"] and 2 ** 64 - 1 in got["bk"]
