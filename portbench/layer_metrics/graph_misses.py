"""Training engine: the steps of the run that did not replay the step's
CUDA graph, from the engine's ``forms`` counters (handed over by the
driver): eager steps, and captures after the first (set-up's warm-up and
capture is the one expected).  ``forms`` gives every counter."""


def read(ctx):
    forms = ctx.spans.get("engine_forms")
    if not forms:
        return None
    misses = forms.get("eager", 0) + max(forms.get("captures", 0) - 1, 0)
    return {"value": float(misses), "forms": dict(forms)}
