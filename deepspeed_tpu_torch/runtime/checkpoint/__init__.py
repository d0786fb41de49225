"""Training checkpoints — counterpart of ``deepspeed_tpu/runtime/checkpoint/``:
the two-phase commit (``manifest``), the sync, fast and async engines
(``engines``), regular save / load (``saver``), the universal fragments
both packages read (``universal``) and ``zero_to_fp32``."""

from .engines import (CheckpointEngine, DecoupledCheckpointEngine,  # noqa: F401
                      FastCheckpointEngine, SyncCheckpointEngine,
                      get_checkpoint_engine)
from .manifest import (MANIFEST_NAME, newest_verifiable_tag,  # noqa: F401
                       retention_sweep, tag_candidates, verify_manifest,
                       with_io_retries, write_manifest)
from .saver import load_checkpoint, resolve_tag, save_checkpoint  # noqa: F401
from .universal import (derive_host_rng, ds_to_universal,  # noqa: F401
                        is_universal_tag, load_universal,
                        load_universal_checkpoint, save_universal,
                        save_universal_checkpoint)
from .zero_to_fp32 import (convert_checkpoint_to_fp32_state_dict,  # noqa: F401
                           get_fp32_state_dict_from_checkpoint)
