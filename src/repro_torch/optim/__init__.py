from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import make_schedule
