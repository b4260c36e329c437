"""Live-board assistant: scrape a BoardGameArena Splendor table and print the
NN+MCTS recommendation every turn (reference splendor_read_board.py:32-389).

Port of ``alphazero_tpu/cli/live_assist.py`` (the same flags, plus
``--device``): the same sprite maps and scrapers, the advice from the
port's ``review_position``.

    python -m alphazero_tpu_torch.cli.live_assist --url URL -c temp/best.pt \
        -m 16000

Requires selenium + a Chrome driver (lazy-imported; a clear error is raised
when absent).  Scraped positions are also written as YAML board specs
compatible with ``cli.advise`` / ``board_dsl.spec_to_state``, so a position
can be re-analyzed offline.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

# ---------------------------------------------------------------------------
# BGA sprite-id maps (external compatibility data: BoardGameArena's sprite
# sheet order; reference splendor_read_board.py:63-167).
# ---------------------------------------------------------------------------
_T1 = {"W": ["W311", "W22", "W3", "W21", "W221", "W2111", "W4", "W1111"],
       "B": ["B21", "B2111", "B1111", "B221", "B311", "B4", "B22", "B3"],
       "G": ["G4", "G22", "G3", "G311", "G2111", "G21", "G221", "G1111"],
       "R": ["R221", "R311", "R21", "R22", "R2111", "R4", "R1111", "R3"],
       "K": ["K4", "K221", "K311", "K3", "K2111", "K1111", "K22", "K21"]}
_T2 = {"W": ["W322", "W332", "W421", "W5", "W53", "W6"],
       "B": ["B332", "B322", "B53", "B421", "B5", "B6"],
       "G": ["G6", "G5", "G53", "G421", "G332", "G322"],
       "R": ["R332", "R322", "R421", "R53", "R5", "R6"],
       "K": ["K322", "K332", "K421", "K5", "K53", "K6"]}
_T3 = {"W": ["W7", "W633", "W5333", "W73"],
       "B": ["B633", "B73", "B7", "B5333"],
       "G": ["G7", "G633", "G5333", "G73"],
       "R": ["R73", "R633", "R7", "R5333"],
       "K": ["K7", "K633", "K73", "K5333"]}

CARDS_BY_SPRITE = {}
_n = 1
for _tier in (_T1, _T2, _T3):
    for _c in "WBGRK":
        for _code in _tier[_c]:
            CARDS_BY_SPRITE[f"card_{_n}"] = _code
            _n += 1
assert _n == 91

NOBLES_BY_SPRITE = {
    "noble_1": "RG", "noble_2": "BG", "noble_3": "BW", "noble_4": "KW",
    "noble_5": "KR", "noble_6": "KBW", "noble_7": "KRG", "noble_8": "KRW",
    "noble_9": "GBR", "noble_10": "GBW",
}

# BGA coin bar order is B,W,K,R,G,gold; specs use W,B,G,R,K,gold
_COIN_ORDER = [1, 0, 4, 3, 2, 5]


def _require_selenium():
    try:
        from selenium import webdriver
        from selenium.common.exceptions import NoSuchElementException
        from selenium.webdriver.common.action_chains import ActionChains
        from selenium.webdriver.common.by import By
    except ImportError as e:  # pragma: no cover - needs selenium
        raise RuntimeError(
            "live_assist needs selenium + chromedriver: pip install selenium "
            "webdriver-manager") from e
    return webdriver, By, ActionChains, NoSuchElementException


def _spl_numbers(board_el, By):
    """Decode a player board's spl_number elements into (bonuses5, coins6)."""
    vals = []
    for el in board_el.find_elements(
            By.XPATH, './/*[contains(@class, "spl_number")]'):
        cls = el.get_attribute("class")
        vals.append(0 if cls.endswith("depleted") else int(cls.split("_")[-1]))
    bonuses, coins = [], []
    for i, v in enumerate(vals):
        if i % 2 == 0 and i != 10:
            bonuses.append(v)
        else:
            coins.append(v)
    return bonuses, coins


def _hover_cards(driver, board_el, By, ActionChains, NoSuchElementException):
    """Hover each spl_cardcount pile and read the tooltip's card sprites."""
    out = []
    for pile in board_el.find_elements(
            By.XPATH, './/*[contains(@class,"spl_cardcount")]'):
        ActionChains(driver).move_to_element(pile).perform()
        time.sleep(0.7)
        try:
            tip = driver.find_element(
                By.XPATH, '//*[@id="dijit__MasterTooltip_0"]/div[2]')
            for card in tip.find_elements(
                    By.XPATH, './/*[contains(@class,"spl_card spl_coloreditem")]'):
                out.append(CARDS_BY_SPRITE[card.get_attribute("id")])
        except NoSuchElementException:
            continue
    return out


def scrape_spec(driver, By, ActionChains, NoSuchElementException,
                reserves: list[list[str]]):
    """One DOM pass -> board spec dict (reference :234-379)."""
    overall = driver.find_element(By.XPATH, '//*[@id="overall-content"]')
    spec = {}

    nobles = overall.find_element(By.XPATH, '//*[@id="noblesbar"]')
    spec["Nobles"] = [
        NOBLES_BY_SPRITE[d.get_attribute("id")]
        for d in nobles.find_elements(By.XPATH, "./div[position() <= 3]")]

    cards = overall.find_element(By.XPATH, '//*[@id="cards"]')
    codes = [CARDS_BY_SPRITE[c.get_attribute("id")] for c in
             cards.find_elements(
                 By.XPATH, './/*[contains(@class, "spl_card spl_coloreditem")]')]
    spec["Tier3"], spec["Tier2"], spec["Tier1"] = (
        codes[:4], codes[4:8], codes[8:])

    coins = overall.find_element(By.XPATH, '//*[@id="coinsbar"]')
    counts = [int(e.text) for e in coins.find_elements(
        By.XPATH, './/*[contains(@class, "coinpile_counter")]')]
    spec["Bank"] = [counts[i] for i in _COIN_ORDER]

    boards = overall.find_element(By.XPATH, '//*[@id="player_boards"]') \
        .find_elements(By.XPATH, './/*[contains(@class, "player-board")]')[:2]
    gems, bonuses, pnobles, bought = [], [], [], []
    for i, b in enumerate(boards):
        bo, co = _spl_numbers(b, By)
        bonuses.append(bo)
        gems.append(co)
        pnobles.append([
            NOBLES_BY_SPRITE[d.get_attribute("id").replace("mininoble", "noble")]
            for d in b.find_elements(
                By.XPATH, './/*[contains(@class, "spl_noble")]')])
        owned = _hover_cards(driver, b, By, ActionChains, NoSuchElementException)
        bought.append(owned)
        for code in owned:       # a reserved card that got bought leaves reserve
            if code in reserves[i]:
                reserves[i].remove(code)
    spec["Gems"], spec["Cards"] = gems, bonuses
    spec["PlayersNobles"], spec["PlayersCards"] = pnobles, bought
    spec["Reserve"] = [list(r) for r in reserves]
    return spec


def scrape_reserves(driver, By):
    """Parse the game log for reserve notifications (reference :195-205)."""
    logs = driver.find_element(By.XPATH, '//*[@id="logs"]')
    per_player: dict[str, list[str]] = {}
    for note in logs.find_elements(
            By.XPATH, './/*[contains(@class, "spl_notif-inner-tooltip")]'):
        player = note.find_element(By.XPATH, "./..").find_element(
            By.XPATH, './span[@class="playername"]').get_attribute("innerHTML")
        code = CARDS_BY_SPRITE["card_" + str(note.get_attribute("data-id"))]
        per_player.setdefault(player, []).append(code)
    return per_player


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--url", required=True, help="BGA table URL")
    p.add_argument("--checkpoint", "-c", required=True)
    p.add_argument("--player", type=int, default=0,
                   help="seat to advise (0=first player)")
    p.add_argument("--numMCTSSims", "-m", type=int, default=16000)
    p.add_argument("--log-dir", default="log")
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a GPU) or 'cpu'")
    args = p.parse_args(argv)

    webdriver, By, ActionChains, NoSuchElementException = _require_selenium()

    import numpy as np
    import yaml

    from ..games.game_api import SplendorGame
    from ..games.splendor import board_dsl as D
    from ..utils import checkpoint as CKPT
    from .review import review_position

    game = SplendorGame(2, device=args.device)
    net, _ = CKPT.load_net(args.checkpoint, game.cfg, game.device)

    driver = webdriver.Chrome()
    driver.get(args.url)
    time.sleep(5)

    names = [e.text for e in driver.find_element(
        By.XPATH, '//*[@id="right-side-first-part"]').find_elements(
        By.XPATH, './/*[contains(@class, "player-name")]')[:2]]
    os.makedirs(args.log_dir, exist_ok=True)

    while True:
        by_name = scrape_reserves(driver, By)
        reserves = [by_name.get(names[0], []), by_name.get(names[1], [])]
        print(f"reserves: {names[0]}={reserves[0]} {names[1]}={reserves[1]}")
        if input("Enter to scrape + advise, 'end' to quit ") == "end":
            break
        spec = scrape_spec(driver, By, ActionChains, NoSuchElementException,
                           reserves)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(args.log_dir, f"board_{stamp}.yaml")
        with open(path, "w") as f:
            yaml.dump(spec, f, sort_keys=False)
        print(f"saved {path}")
        board = D.spec_to_state(spec, 2, args.player)
        game.printBoard(board)
        review_position(game, net, np.asarray(board), args.numMCTSSims)

    driver.quit()


if __name__ == "__main__":
    main()
