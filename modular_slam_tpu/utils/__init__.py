from modular_slam_tpu.utils.jaxtools import (  # noqa: F401
    compile_cache_dir,
    setup_compile_cache,
)
