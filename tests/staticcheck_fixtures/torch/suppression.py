"""Suppression-mechanics fixture of the port's checker.

* `reasoned` carries a proper `# btf: disable=BTF001 <reason>` —
  its finding is SUPPRESSED.
* `bare` carries a reason-less disable — the BTF001 finding STAYS
  unsuppressed AND a BTF000 bare-suppression finding is added.
* `multiline` shows a standalone comment suppressing the whole next
  (multi-line) statement.
"""
import urllib.request


def reasoned(url):
    return urllib.request.urlopen(url)  # btf: disable=BTF001 fixture: demonstrates a reasoned suppression


def bare(url):
    return urllib.request.urlopen(url)  # btf: disable=BTF001


def multiline(url, host):
    # btf: disable=BTF001 fixture: covers the whole next statement
    return urllib.request.urlopen(
        url,
    )
