"""The JAX engine v2 and the port's, built on the same tiny Llama weights,
for the port's serving-core parity tests (``test_torch_engine_v2_*.py``).

The JAX engine runs in fp32 by handing its constructor fp32
``apply_paged`` / ``init_paged_cache`` partials; the port runs with
``dtype: float32`` on the CPU. Both take the same config dict.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from deepspeed_tpu.comm import mesh as mesh_lib
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.inference.engine import ModelFamily as JFamily
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.inference import build_engine_v2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import from_jax_params

BASE = {"dtype": "float32", "prefill_bucket": 16,
        "ragged": {"max_tracked_sequences": 4, "max_ragged_batch_size": 4,
                   "memory_config_blocks": 64, "block_size": 8}}


class Pair:
    """Tiny Llama (max_seq_len 128) weights and engine builders for both
    packages: ``jax(**conf)`` / ``port(**conf)`` merge ``conf`` into
    :data:`BASE` (a ``ragged`` dict merges key by key). Another family:
    its two modules (``jmod``, ``tmod``), the name of its config class and
    the ``tiny`` fields to change; ``params`` (numpy leaves) replace the
    JAX ``init``'s."""

    def __init__(self, jmod=jllama, tmod=tllama, config="LlamaConfig", params=None,
                 **cfg_kw):
        self.jmod, self.tmod = jmod, tmod
        self.jcfg = getattr(jmod, config).tiny(max_seq_len=128, **cfg_kw)
        self.tcfg = getattr(tmod, config).tiny(max_seq_len=128, **cfg_kw)
        self.params = params if params is not None else \
            jax.tree.map(np.asarray, jmod.init(self.jcfg, jax.random.PRNGKey(0)))
        self.sd = from_jax_params(self.tcfg, self.params)
        self.vocab = self.tcfg.vocab_size

    @staticmethod
    def config(**conf) -> dict:
        out = copy.deepcopy(BASE)
        ragged = conf.pop("ragged", {})
        out["ragged"].update(ragged)
        out.update(conf)
        return out

    def jax(self, **conf) -> JEngine:
        mesh_lib.set_mesh(None)
        jm = self.jmod
        return JEngine(JFamily.from_module(jm, self.jcfg), self.params,
                       JConfig.from_dict(self.config(**conf)),
                       init_paged_cache=partial(jm.init_paged_cache, dtype=jnp.float32),
                       apply_paged=partial(jm.apply_paged, compute_dtype=jnp.float32))

    def port(self, **conf):
        return build_engine_v2(self.tmod, self.tcfg, self.sd, config=self.config(**conf),
                               device="cpu")

    def prompts(self, lengths, seed=0):
        rs = np.random.RandomState(seed)
        return [rs.randint(0, self.vocab, n).astype(np.int32) for n in lengths]


def ints(streams):
    """JAX token streams as plain int lists."""
    return [[int(t) for t in s] for s in streams]
