"""The train step's rate, as train_mrays_per_s would read it: width x
height x effective samples of the traffic's `traced_rate_units` steps that
a traced run makes unprofiled after its slice, over their host seconds
(the last one's `torch.cuda.synchronize()` included). Across runs it
spreads with the shared host's speed by more than any bound can hold, so
it stands here without a bound. Moves setup_s (set-up drives the first
steps)."""


def read(run):
    return run.traced_rate
