"""Backward calls of ``PlainVJP`` (the ViT kernels' gradient: K5 and K6,
two a trained vision block) per step in the traced block, from the
program's counter ``PlainVJP.backward_calls``. A count: it repeats
exactly; 0 with a frozen trunk."""


def read(facts):
    return facts.get("vjp_calls_per_step")
