"""The general drivers a traffic mix names (``"driver"`` in its file):
``sim`` steps the batched env with a random policy, ``learner`` trains
the a3c conv-GRU learner."""
