"""App / access-key / channel lifecycle commands (port of
``predictionio_tpu/tools/apps.py``).

Reference: tools/.../commands/App.scala (create :31-98, list :100-110,
show :111-127, delete :128-193, dataDelete :194-266, channelNew :267-328,
channelDelete :329+) and commands/AccessKey.scala.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.storage import (
    AccessKey, App, Channel, Storage, get_storage,
)


class CommandError(RuntimeError):
    pass


@dataclasses.dataclass
class AppDescription:
    app: App
    keys: Sequence[AccessKey]


def _storage(storage: Optional[Storage]) -> Storage:
    return storage if storage is not None else get_storage()


def create(name: str, app_id: Optional[int] = None,
           description: Optional[str] = None, access_key: str = "",
           storage: Optional[Storage] = None) -> AppDescription:
    """Create app + event store + default access key (App.scala:31-98)."""
    storage = _storage(storage)
    apps = storage.get_meta_data_apps()
    events = storage.get_events()
    if apps.get_by_name(name) is not None:
        raise CommandError(f"App {name} already exists. Aborting.")
    if app_id is not None and apps.get(app_id) is not None:
        existing = apps.get(app_id)
        raise CommandError(
            f"App ID {app_id} already exists and maps to the app "
            f"'{existing.name}'. Aborting.")
    if app_id is not None and app_id <= 0:
        raise CommandError(f"App ID {app_id} is invalid: must be positive.")
    new_id = apps.insert(App(id=app_id if app_id is not None else 0,
                             name=name, description=description))
    if new_id is None:
        raise CommandError("Unable to create new app.")
    if not events.init(new_id):
        try:
            apps.delete(new_id)
        except Exception:
            raise CommandError(
                f"Unable to initialize Event Store for this app ID: {new_id}."
                f"\nFailed to revert back the App meta-data change."
                f"\nThe app {name} CANNOT be used!"
                f"\nPlease run 'pio app delete {name}' to delete this app!")
        raise CommandError(
            f"Unable to initialize Event Store for this app ID: {new_id}.")
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(key=access_key, appid=new_id, events=()))
    if key is None:
        raise CommandError("Unable to create new access key.")
    return AppDescription(app=App(new_id, name, description),
                          keys=[AccessKey(key, new_id, ())])


def list_apps(storage: Optional[Storage] = None) -> List[AppDescription]:
    storage = _storage(storage)
    access_keys = storage.get_meta_data_access_keys()
    return [
        AppDescription(app=app, keys=access_keys.get_by_appid(app.id))
        for app in sorted(storage.get_meta_data_apps().get_all(),
                          key=lambda a: a.name)]


def show(app_name: str, storage: Optional[Storage] = None
         ) -> Tuple[AppDescription, List[Channel]]:
    storage = _storage(storage)
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise CommandError(f"App {app_name} does not exist. Aborting.")
    keys = storage.get_meta_data_access_keys().get_by_appid(app.id)
    channels = storage.get_meta_data_channels().get_by_appid(app.id)
    return AppDescription(app=app, keys=keys), channels


def delete(name: str, storage: Optional[Storage] = None) -> None:
    """Delete an app: channels' event stores, app events, keys, meta row
    (App.scala:128-193)."""
    storage = _storage(storage)
    apps = storage.get_meta_data_apps()
    app = apps.get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    events = storage.get_events()
    channels = storage.get_meta_data_channels()
    for ch in channels.get_by_appid(app.id):
        if not events.remove(app.id, ch.id):
            raise CommandError(
                f"Error removing Event Store of channel {ch.name}.")
        channels.delete(ch.id)
    if not events.remove(app.id):
        raise CommandError(f"Error removing Event Store for app {name}.")
    access_keys = storage.get_meta_data_access_keys()
    for k in access_keys.get_by_appid(app.id):
        access_keys.delete(k.key)
    apps.delete(app.id)


def data_delete(name: str, channel: Optional[str] = None,
                delete_all: bool = False,
                storage: Optional[Storage] = None) -> None:
    """Wipe event data (all channels with delete_all) but keep the app
    (App.scala:194-266). remove+init = truncate."""
    storage = _storage(storage)
    app = storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    events = storage.get_events()
    channels = storage.get_meta_data_channels()
    chans = channels.get_by_appid(app.id)
    if channel is not None:
        match = [c for c in chans if c.name == channel]
        if not match:
            raise CommandError(
                f"Unable to delete data for channel. Channel {channel} "
                "doesn't exist.")
        targets = [match[0].id]
    elif delete_all:
        targets = [None] + [c.id for c in chans]
    else:
        targets = [None]
    for cid in targets:
        if not (events.remove(app.id, cid) and events.init(app.id, cid)):
            raise CommandError(
                f"Error removing Event Store data for app {name}"
                + (f" channel id {cid}." if cid else "."))


def channel_new(app_name: str, channel_name: str,
                storage: Optional[Storage] = None) -> Channel:
    """Create a channel + its event store (App.scala:267-328)."""
    storage = _storage(storage)
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise CommandError(f"App {app_name} does not exist. Aborting.")
    channels = storage.get_meta_data_channels()
    if any(c.name == channel_name for c in channels.get_by_appid(app.id)):
        raise CommandError(
            f"Unable to create new channel. Channel {channel_name} already "
            "exists.")
    if not Channel.is_valid_name(channel_name):
        raise CommandError(
            f"Unable to create new channel. The channel name {channel_name} "
            "is invalid. Only alphanumeric and - characters are allowed and "
            "max length is 16.")
    cid = channels.insert(Channel(id=0, name=channel_name, appid=app.id))
    if cid is None:
        raise CommandError("Unable to create new channel.")
    if not storage.get_events().init(app.id, cid):
        channels.delete(cid)
        raise CommandError(
            "Unable to create new channel. Failed to initialize Event Store.")
    return Channel(cid, channel_name, app.id)


def channel_delete(app_name: str, channel_name: str,
                   storage: Optional[Storage] = None) -> None:
    storage = _storage(storage)
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise CommandError(f"App {app_name} does not exist. Aborting.")
    channels = storage.get_meta_data_channels()
    match = [c for c in channels.get_by_appid(app.id)
             if c.name == channel_name]
    if not match:
        raise CommandError(
            f"Unable to delete channel. Channel {channel_name} doesn't "
            "exist.")
    if not storage.get_events().remove(app.id, match[0].id):
        raise CommandError(
            "Unable to delete channel. Error removing Event Store.")
    channels.delete(match[0].id)


# -- access keys (commands/AccessKey.scala) ---------------------------------

def accesskey_new(app_name: str, key: str = "",
                  events: Sequence[str] = (),
                  storage: Optional[Storage] = None) -> AccessKey:
    storage = _storage(storage)
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise CommandError(f"App {app_name} does not exist. Aborting.")
    k = storage.get_meta_data_access_keys().insert(
        AccessKey(key=key, appid=app.id, events=tuple(events)))
    if k is None:
        raise CommandError("Unable to create new access key.")
    return AccessKey(k, app.id, tuple(events))


def accesskey_list(app_name: Optional[str] = None,
                   storage: Optional[Storage] = None) -> List[AccessKey]:
    storage = _storage(storage)
    access_keys = storage.get_meta_data_access_keys()
    if app_name is None:
        return sorted(access_keys.get_all(), key=lambda k: k.appid)
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise CommandError(f"App {app_name} does not exist. Aborting.")
    return access_keys.get_by_appid(app.id)


def accesskey_delete(key: str, storage: Optional[Storage] = None) -> None:
    storage = _storage(storage)
    access_keys = storage.get_meta_data_access_keys()
    if access_keys.get(key) is None:
        raise CommandError(f"Access key {key} does not exist. Aborting.")
    access_keys.delete(key)
