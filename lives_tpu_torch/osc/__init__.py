"""External control plane: OSC server + notify sockets (reference L10).

Counterpart of `lives_tpu/osc/__init__.py:1-4`."""

from .client import OSCClient
from .protocol import OSCMessage, build_message, parse_packet
from .server import OSCServer, NOTIFY
