"""The benchmark's yardstick: finding a cell's files, the card, seeds,
weights, traces, kernel work, output checks and the result line."""
