"""deepspeed_tpu_torch.inference — the KV-cached greedy serving engine
(port of ``deepspeed_tpu/inference``'s unpaged path; docs/serving.md)."""
from .engine import ServeEngine  # noqa: F401
from .kv_cache import KVCacheSpec, init_cache  # noqa: F401
from .scheduler import Request, SlotScheduler  # noqa: F401
from .speculative import select_next_token  # noqa: F401
