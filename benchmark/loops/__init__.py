"""The loops that drive the timed window, one file per `loop` a traffic
file names."""
