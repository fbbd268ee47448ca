"""Event import/export jobs (port of
``predictionio_tpu/tools/transfer.py``).

Reference: tools/.../imprt/FileToEvents.scala:38-106 and
export/EventsToFile.scala:37-108 — JSON-lines file <-> event store. The
reference ran these as spark-submit jobs; here they are direct columnar
reads/writes in-process.
"""

from __future__ import annotations

import json
from typing import Optional

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.tools.apps import CommandError


def _resolve(storage: Storage, app_id: int, channel: Optional[str]):
    channel_id = None
    if channel:
        chans = storage.get_meta_data_channels().get_by_appid(app_id)
        match = [c for c in chans if c.name == channel]
        if not match:
            raise CommandError(f"Channel {channel} not found for app {app_id}")
        channel_id = match[0].id
    return channel_id


def file_to_events(path: str, app_id: int, channel: Optional[str] = None,
                   storage: Optional[Storage] = None) -> int:
    """Import a JSON-lines file of events; returns the count
    (FileToEvents.scala:38-106)."""
    storage = storage if storage is not None else get_storage()
    channel_id = _resolve(storage, app_id, channel)
    events_dao = storage.get_events()
    count = 0
    batch = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                batch.append(Event.from_dict(json.loads(line)))
            except ValueError as e:
                raise CommandError(f"{path}:{line_no}: {e}") from None
            if len(batch) >= 1000:
                events_dao.insert_batch(batch, app_id, channel_id)
                count += len(batch)
                batch = []
    if batch:
        events_dao.insert_batch(batch, app_id, channel_id)
        count += len(batch)
    return count


def events_to_file(path: str, app_id: int, channel: Optional[str] = None,
                   storage: Optional[Storage] = None) -> int:
    """Export an app's events to a JSON-lines file; returns the count
    (EventsToFile.scala:37-108)."""
    storage = storage if storage is not None else get_storage()
    channel_id = _resolve(storage, app_id, channel)
    count = 0
    with open(path, "w") as f:
        for e in storage.get_events().find(app_id=app_id,
                                           channel_id=channel_id):
            f.write(e.to_json() + "\n")
            count += 1
    return count
