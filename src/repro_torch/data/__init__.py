"""Data for the port: synthetic problems and the ragged TaskStore."""
from repro_torch.data.store import (StoreUndo, TaskStore, TaskStoreState,
                                    stack_ragged)
from repro_torch.data.synthetic import (make_mnist_like, make_mtl_problem,
                                        make_school_like)

__all__ = ["make_mtl_problem", "make_school_like", "make_mnist_like",
           "TaskStore", "TaskStoreState", "StoreUndo", "stack_ragged"]
