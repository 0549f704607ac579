"""serve.pad_share: the share of the samples reaching ``model.separate`` in
the window that are padding, from the harness's count at the model boundary
(each call's rows x bucket samples) against the audio samples sent."""

READS = ("counters",)


def read(r):
    calls = r.counters.get("calls")
    if not calls:
        return None
    batch = sum(rows * samples for rows, samples in calls)
    return 100.0 * (batch - r.counters["audio_samples"]) / batch
