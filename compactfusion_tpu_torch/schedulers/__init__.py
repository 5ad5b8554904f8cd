"""schedulers (PyTorch port of compactfusion_tpu/schedulers)."""

from compactfusion_tpu_torch.schedulers.diffusion import (  # noqa: F401
    DDPMSchedule,
    DPMState,
    ddim_step,
    ddpm_schedule,
    ddpm_step,
    dpm_init_state,
    dpm_step,
)
from compactfusion_tpu_torch.schedulers.flow_match import (  # noqa: F401
    FlowMatchSchedule,
    flow_match_schedule,
    flow_match_step,
)
