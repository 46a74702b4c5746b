"""The benchmark's frozen yardstick: the card's peaks and the work
(bytes moved, operations) of each kernel launch, from its shape."""
