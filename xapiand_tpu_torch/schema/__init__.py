"""Schema'd document model: field types, `_`-keyword processing, type
inference, term/value generation.

Reference parity target: src/database/schema.{h,cc} (the reference's largest
first-party component, ~11k LoC).
"""

from xapiand_tpu_torch.schema.types import FieldType, TypeIndex  # noqa: F401
from xapiand_tpu_torch.schema.schema import Schema, IndexedDocument, SchemaError  # noqa: F401
