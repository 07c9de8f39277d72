# -*- coding: utf-8 -*-
from .mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    use_mesh,
    active_mesh,
    set_active_mesh,
    resolve_parallel,
    init_distributed,
    cluster_cleanup,
    esi_cluster_setup,
    TRIAL_AXIS,
    CHANNEL_AXIS,
)
