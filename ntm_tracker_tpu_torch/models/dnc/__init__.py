from ntm_tracker_tpu_torch.models.dnc.addressing import (
    TemporalLinkageState,
    cosine_weights,
    directional_read_weights,
    temporal_linkage_update,
    usage_update,
    write_allocation_weights,
)
from ntm_tracker_tpu_torch.models.dnc.access import (
    AccessState,
    erase_and_write,
    init_access_params,
    init_access_state,
    memory_access_step,
)
from ntm_tracker_tpu_torch.models.dnc.dnc import (
    DNCState,
    dnc_step,
    dnc_unroll,
    init_dnc_params,
    init_dnc_state,
)
