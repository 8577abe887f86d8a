"""K1's share of its roofline: the least time of one refinement call
(``counts.refine_work`` at the sweep's batch, 256², 2 classes) over its
device time a call, the ``refine_*`` kernels of the traced round over the
calls the program counted in it (``refine_cuda.launches``, graph replays
included). K1 runs inside the sweep's CUDA graph, where no event of the
benchmark's can bracket it, so its time is the trace's."""

from benchmark import counts, readings

KERNELS = r"\brefine_(init|affinity|pairs|window|update|threshold)\b"


def read(run):
    calls = run.extra.get("traced_k1_launches")
    ms = readings.kernel_ms(run, KERNELS)
    if not calls or ms is None:
        return None
    rp, size = run.params["refine"], run.config["image_size"]
    nbytes, ops = counts.refine_work(run.extra["batch"], size, size, run.config["num_classes"],
                                     rp["window_size"], rp["num_steps"], rp["loss"])
    bound, _ = counts.roofline(nbytes, ops)
    return readings.share(bound, ms / calls)
