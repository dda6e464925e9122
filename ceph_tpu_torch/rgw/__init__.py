"""Object gateway layer (src/rgw/ role)."""
from .gateway import Bucket, RGWError, RGWGateway  # noqa: F401
from .sync import BucketSyncAgent, make_sync_engine  # noqa: F401
from .users import UserError, UserStore  # noqa: F401
from .zone import (Period, PeriodSync, Realm, RealmError,  # noqa: F401
                   Zone, ZoneGroup)
