from .kernel import (  # noqa: F401
    sim_messages, sim_messages_plain, sim_push, sim_push_plain)
