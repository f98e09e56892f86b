"""Shared helpers of the PyTorch port's tests (``test_torch_*.py``).

Inputs are made with numpy and handed to both the JAX reference and the
port with identical values; nothing here runs on a GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import aot as jax_aot
from repro.core import peft as jpeft
from repro_torch import bridge
from repro_torch.core import peft as port_peft

TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def both(x, dtype=jnp.float32):
    """numpy values -> (jax array, torch tensor) holding identical values of
    ``dtype`` (bf16 is rounded once, by JAX, then carried over exactly)."""
    if np.issubdtype(np.asarray(x).dtype, np.integer):     # indices: as is
        xj = jnp.asarray(x)
        return xj, torch.from_numpy(np.asarray(xj).copy())
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).copy())
    return xj, xt.to(TORCH[dtype])


def np32(x):
    """A JAX array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def jax_tasks(cfg, params, n):
    """``n`` fused task tables from the reference's ``random_fused``."""
    return [jax_aot.random_fused(cfg, params["embed"]["tok"], seed=s)
            for s in range(n)]


def jax_peft(tasks, task_ids):
    """The reference's multi-task fused-AoT bundle for ``mixed_step``."""
    opt = jpeft.PEFTOptions(method="aot",
                            aot=jax_aot.AoTOptions(mode="fused"))
    p = jpeft.make({"aot": jax_aot.stack_tasks(tasks)}, opt)
    p["task_ids"] = task_ids
    return p


def port_tasks_peft(tables, task_ids):
    """The port's multi-task fused-AoT bundle (as its ``ServeEngine`` builds
    it) for stacked ``tables`` ``{"table": (L, tasks, V, d)}``."""
    opt = port_peft.PEFTOptions(method="aot",
                                aot=port_peft.AoTOptions(mode="fused"))
    return dict(port_peft.make({"aot": tables}, opt), task_ids=task_ids)


def port_lm(tiny_lm):
    """The port's model and parameters carrying the reference's
    ``tiny_lm`` weights, on the CPU."""
    from repro_torch.models.model import Model
    cfg, _, params = tiny_lm
    model = Model(cfg, device="cpu")
    return model, bridge.params_from_jax(cfg, jax.device_get(params),
                                         device="cpu")


def port_tables(tasks):
    return bridge.tables_from_jax(jax.device_get(tasks), device="cpu")
