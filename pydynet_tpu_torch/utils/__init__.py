from .checkpoint import (save_checkpoint, load_checkpoint, state_dict,
                         load_state_dict, read_extra)
from .debug import check_finite, debug_nans
from .profiler import StepTimer, trace
from .sharded_checkpoint import (load_sharded, load_sharded_tree,
                                 save_sharded, save_sharded_tree)
