"""R12 fixture: a checkpoint-commit barrier dominated by a rank branch —
the regression shape for the rank-divergent commit deadlock."""


def barrier():
    """Stand-in collective; R12 keys on the callee NAME."""


def divergent_commit(rank, state):
    if rank == 0:
        _commit(state)
        barrier()


def uniform_commit(rank, state):
    # negative: the branch is rank-dependent but every rank still reaches
    # the same collective sequence afterwards
    if rank == 0:
        _commit(state)
    barrier()


def _commit(state):
    state["committed"] = True


class CollectiveConfig:
    """Stand-in; R12's config arm keys on the callee NAME."""

    def __init__(self, compression="none", quant_block_bytes=256):
        self.compression = compression
        self.quant_block_bytes = quant_block_bytes


def divergent_config(rank):
    # positive: a per-rank compression scheme folds into the rendezvous
    # fingerprint and diverges at the group's first op
    return CollectiveConfig(compression="q8" if rank == 0 else "none")


def uniform_config():
    # negative: one literal config for the whole group
    return CollectiveConfig(compression="q8", quant_block_bytes=512)
