"""Realtime (speed) layer: streaming fold-in of events into servable
factors (port of ``predictionio_tpu/realtime``).

``realtime.foldin`` tails the event store through a persistent cursor,
re-solves dirty users' (and unseen items') factor rows against the fixed
other-side matrix with the training ALS half-step (kernel A on the card),
and publishes the rows atomically into the LIVE serving model, so a user
who signed up seconds ago gets a personalized top-k without a retrain, a
restart or a dropped query.
"""

from predictionio_tpu_torch.realtime import foldin  # noqa: F401
