"""Filter op library + plugin registry (port of ``dvf_tpu.ops``).

Importing this package registers the builtin filters under the reference
package's names.
"""

from dvf_tpu_torch.ops.registry import get_filter, list_filters, register_filter  # noqa: F401

# Builtin filter modules register themselves on import.
from dvf_tpu_torch.ops import pointwise  # noqa: F401,E402
from dvf_tpu_torch.ops import conv  # noqa: F401,E402
from dvf_tpu_torch.ops import bilateral  # noqa: F401,E402
from dvf_tpu_torch.ops import chains  # noqa: F401,E402
from dvf_tpu_torch.ops import flow  # noqa: F401,E402
from dvf_tpu_torch.ops import kernels  # noqa: F401,E402
from dvf_tpu_torch.ops import style  # noqa: F401,E402
from dvf_tpu_torch.ops import sr  # noqa: F401,E402
from dvf_tpu_torch.ops import histogram  # noqa: F401,E402
from dvf_tpu_torch.ops import canny  # noqa: F401,E402
