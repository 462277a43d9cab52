"""Query layer (torch port): the logical IR and the IR -> device-plan
compiler, copies of ``xapiand_tpu/query/ir.py`` and ``plan.py``."""

from xapiand_tpu_torch.query.ir import Q  # noqa: F401
