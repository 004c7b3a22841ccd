from .episode import (  # noqa: F401
    EpisodeConfig,
    EpisodeResult,
    run_episode,
    run_episodes_batch,
    run_episodes_fused,
)
