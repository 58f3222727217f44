"""The elastic re-slice drill on four gloo ranks: the port's counterpart
of ``tests/test_elastic.py::test_elastic_reslice_16_to_8``.

One spawned world runs, per backend (``full`` over ``model`` and ``2d``,
ZeRO-3 ``robe``, ``hashed``, ``tt``), 20 adagrad steps of the JAX drill's
DLRM on a (2, 2) mesh under ``train_loop.run`` with a ``FaultPlan``
straggler at steps 7-9: the agreed trigger re-slices at the step-10
checkpoint onto (2, 1) (``model`` halved), ranks 1 and 3 leave the loop,
and ranks 0 and 2 train on to step 20.  The survivors then run a clean
two-rank run restored from the same checkpoint.  The test holds the
survivors' losses of steps 10-19 within 1e-5 of that clean run and of
``repro``'s single-device ``run`` restored from the same checkpoint, and
the event to ``ResliceEvent(step=10, devices_before=4, devices_after=2,
restored_step=10)``.  Without a checkpoint directory (``full`` ``2d``)
the controller gathers the live state over the old mesh and places it on
the survivors: the same trajectory, ``restored_step=None``.
"""

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

from test_torch_dist_ranks import init_world, run_cases, spawn_world

VOCABS = (512, 256, 384)
KW = dict(name="e", arch="dlrm", n_dense=4, bot_mlp=(16, 8),
          top_mlp=(16, 1), embed_dim=8, vocab_sizes=VOCABS, robe_size=2048,
          robe_block=8)
BACKENDS = {
    "full": dict(embedding="full"),
    "full-2d": dict(embedding="full", full_table_shard="2d"),
    "robe-z3": dict(embedding="robe", robe_shard_model=True),
    "hashed": dict(embedding="hashed"),
    "tt": dict(embedding="tt"),
}
LIVE = ("full-2d",)
N_STEPS, AT = 20, 10
TOL = 1e-5


def _drill(ctx4, inputs, tmp, kind, live=False):
    """One backend's drill on this rank (torch only); ``live``: no
    checkpoints, the controller re-places the live state."""
    from repro_torch.convert import params_from_numpy, params_onto_mesh
    from repro_torch.data.synthetic_ctr import CtrDataConfig, CtrStream
    from repro_torch.dist import api as dist
    from repro_torch.dist.param_specs import recsys_specs
    from repro_torch.models.recsys import RecsysConfig, loss_fn
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import elastic
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_loop import (TrainConfig, build_train_step,
                                              init_state, run)
    cfg = RecsysConfig(**KW, **BACKENDS[kind])
    whole = params_from_numpy(inputs["params"][kind], "cpu")
    spec = cfg.embedding_spec()
    stream = CtrStream(CtrDataConfig(vocab_sizes=VOCABS, n_dense=4,
                                     batch_size=256))
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="adagrad", lr=0.05))
    tc = TrainConfig(checkpoint_every=5, straggler_factor=3.0,
                     straggler_patience=3)

    def pspecs(ctx):
        return dist.prune_specs(recsys_specs(whole, ctx.rules, spec,
                                             mesh=ctx.mesh), whole, ctx.mesh)

    def specs_for(ctx, state):
        return elastic.train_state_specs(state, pspecs(ctx), ctx.rules)

    def build_step(ctx):
        return build_train_step(lambda p, b: loss_fn(p, cfg, b), opt, tc,
                                specs=pspecs(ctx))

    ckpt = None if live else str(Path(tmp, f"ckpt-{kind}"))
    plan = elastic.FaultPlan(slow_steps={7: 1.0, 8: 1.0, 9: 1.0})
    ctrl = elastic.ResliceController(state_specs=specs_for,
                                     build_step=build_step, ckpt_dir=ckpt)
    with dist.use(ctx4):
        state = init_state(params_onto_mesh(inputs["params"][kind],
                                            pspecs(ctx4), ctx4), opt, tc)
        rep = run(state, plan.wrap_step_fn(build_step(ctx4)),
                  stream.batch_at, N_STEPS, tc, ckpt_dir=ckpt,
                  reslice_fn=ctrl, timer=plan.clock)
        ctx2 = dist.current()
    out = {"losses": rep.losses, "left_at": rep.left_at,
           "reslices": rep.reslices, "steps_done": rep.steps_done,
           "events": [dataclasses.asdict(e) for e in ctrl.events],
           "devices_after": ctx2.n_devices, "clean": None}
    if ctx2.is_member and not live:
        # the clean run: the survivors restore the same snapshot
        with dist.use(ctx2):
            template = init_state(params_onto_mesh(
                inputs["params"][kind], pspecs(ctx2), ctx2), opt, tc)
            restored = ck.restore_onto(ckpt, template, ctx2,
                                       specs_for(ctx2, template), step=AT)
            state_c, manifest = restored
            rep_c = run(state_c, build_step(ctx2), stream.batch_at, N_STEPS,
                        tc)
        out["clean"] = rep_c.losses
        out["clean_step"] = int(manifest["step"])
    return out


def _rank_main(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as tdist

    from repro_torch.dist import api as dist
    from repro_torch.launch.mesh import make_mesh
    init_world(rank, world, tmp)
    inputs = pickle.loads(Path(tmp, "inputs.pkl").read_bytes())

    def case(kind, live=False):
        ctx4 = dist.DistContext(mesh=make_mesh((2, 2), ("data", "model"),
                                               device="cpu"),
                                rules=dist.default_rules())
        return _drill(ctx4, inputs, tmp, kind, live)

    cases = {k: (lambda k: lambda: case(k))(k) for k in BACKENDS}
    cases.update({f"live/{k}": (lambda k: lambda: case(k, True))(k)
                  for k in LIVE})
    run_cases(cases, rank, tmp)
    tdist.barrier()
    tdist.destroy_process_group()


def _jax_restored_losses(kind, params_np, ckpt):
    """``repro``'s single-device run of steps 10-19 from the port's
    step-10 checkpoint."""
    import jax
    import jax.numpy as jnp

    from repro.data.synthetic_ctr import CtrDataConfig, CtrStream
    from repro.models.recsys import RecsysConfig, loss_fn
    from repro.train import checkpoint as jck
    from repro.train import optimizer as jopt
    from repro.train.train_loop import (TrainConfig, build_train_step,
                                        init_state, run)
    cfg = RecsysConfig(**KW, **BACKENDS[kind], compute_dtype=jnp.float32)
    opt = jopt.make_optimizer(jopt.OptimizerConfig(kind="adagrad", lr=0.05))
    tc = TrainConfig(checkpoint_every=5, straggler_factor=3.0,
                     straggler_patience=3)
    template = init_state(jax.tree.map(jnp.asarray, params_np), opt, tc)
    state, manifest = jck.restore_latest(ckpt, template, step=AT)
    assert int(manifest["step"]) == AT
    stream = CtrStream(CtrDataConfig(vocab_sizes=VOCABS, n_dense=4,
                                     batch_size=256))
    step = build_train_step(lambda p, b: loss_fn(p, cfg, b), opt, tc)
    return run(jax.tree.map(jnp.asarray, state), step, stream.batch_at,
               N_STEPS, tc).losses


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    import jax

    from repro.models.recsys import RecsysConfig, init_params
    tmp = tmp_path_factory.mktemp("drill")
    params = {k: jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), RecsysConfig(**KW, **v)))
        for k, v in BACKENDS.items()}
    (tmp / "inputs.pkl").write_bytes(pickle.dumps({"params": params}))
    return {"tmp": tmp, "params": params,
            "ranks": spawn_world("test_torch_reslice", tmp)}


@pytest.mark.parametrize("kind", sorted(BACKENDS))
def test_reslice_4_to_2_matches_clean_restore_and_jax(drill, kind):
    ranks = [r[kind] for r in drill["ranks"]]
    for rank, r in enumerate(ranks):
        if "error" in r:
            pytest.fail(f"rank {rank} raised:\n{r['error']}")
    want_event = dict(step=AT, devices_before=4, devices_after=2,
                      restored_step=AT)
    for rank, r in enumerate(ranks):
        assert r["events"] == [want_event], (rank, r["events"])
        assert r["reslices"] == 1 and r["devices_after"] == 2
    # ranks 1 and 3 (model index 1) leave at the re-slice step
    for rank in (1, 3):
        assert ranks[rank]["left_at"] == AT
        assert len(ranks[rank]["losses"]) == AT
        assert ranks[rank]["clean"] is None
    survivors = [ranks[0], ranks[2]]
    for r in survivors:
        assert r["left_at"] is None and r["steps_done"] == N_STEPS
        assert len(r["losses"]) == N_STEPS and r["clean_step"] == AT
    # every rank reports the same global losses
    assert survivors[0]["losses"] == survivors[1]["losses"]
    assert ranks[1]["losses"] == survivors[0]["losses"][:AT]
    after = np.asarray(survivors[0]["losses"][AT:])
    clean = np.asarray(survivors[0]["clean"])
    assert clean.shape == after.shape
    assert float(np.max(np.abs(after - clean))) < TOL
    jlosses = np.asarray(_jax_restored_losses(
        kind, drill["params"][kind], str(drill["tmp"] / f"ckpt-{kind}")))
    assert float(np.max(np.abs(after - jlosses))) < TOL


@pytest.mark.parametrize("kind", LIVE)
def test_reslice_without_a_checkpoint_replaces_the_live_state(drill, kind):
    ranks = [r[f"live/{kind}"] for r in drill["ranks"]]
    for rank, r in enumerate(ranks):
        if "error" in r:
            pytest.fail(f"rank {rank} raised:\n{r['error']}")
        assert r["events"] == [dict(step=AT, devices_before=4,
                                    devices_after=2, restored_step=None)]
    assert [r["left_at"] for r in ranks] == [None, AT, None, AT]
    with_ckpt = np.asarray(drill["ranks"][0][kind]["losses"])
    live = np.asarray(ranks[0]["losses"])
    assert live.shape == with_ckpt.shape == (N_STEPS,)
    assert float(np.max(np.abs(live - with_ckpt))) < TOL
