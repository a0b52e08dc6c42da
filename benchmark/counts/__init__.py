"""The benchmark's yardstick: published peaks of the card, and the
operations and bytes of each kernel and of a whole model step, all
computed from shapes. Frozen here so that a change to the program cannot
move the measure it is judged by."""
